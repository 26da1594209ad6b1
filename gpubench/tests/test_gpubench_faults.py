"""The check that decides ``correct`` has to fail: the harness driven on the
CPU (its look for a card skipped) at a tiny cell, with the timed path broken
underneath, and the control (the reference in the next precision down put
in the program's place) held to the same limits."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import check, harness, reference
from gpubench.runners import serve
from gpubench.tests.tiny import tiny_root

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def test_a_sound_run_is_correct(root):
    line = harness.run(root, "tiny.serve", 2 ** 31 + 3, 0.1, False, time.perf_counter(),
                       device=CPU, emit=lambda s: None)
    assert line["correct"] is True


@pytest.mark.parametrize("fault", serve.FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(root, fault):
    line = harness.run(root, "tiny.serve", 2 ** 31 + 5, 0.1, False, time.perf_counter(),
                       device=CPU, fault=fault, emit=lambda s: None)
    assert line["correct"] is False
    failed = {k for k, c in line["checks"].items() if not c["value"] <= c["limit"]}
    if fault != "answer_altered":
        # a fault past the prefix is caught by a number of the whole clip
        assert failed & {"enh_wave_err", "enh_segment_rms_err"}


def test_the_control_fails_the_limits(root):
    c = harness.Cell(root, "tiny.serve")
    res = c.runner().run(c, 7, 0, False, CPU)
    ref = res["reference"](reference.PLAIN)
    control = res["compare"](res["reference"](harness.CONTROLS[c.precision]), ref)
    assert not check.passed(check.judge(control, c.limits))
