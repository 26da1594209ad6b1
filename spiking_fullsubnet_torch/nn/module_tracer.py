"""Per-module activation tracer: abs-min/max frames and an abort on the
first non-finite one (counterpart of ``spiking_fullsubnet_tpu/nn/
module_tracer.py``; reference audiozen/debug_utils.py:7-268,
DebugUnderflowOverflow).

Model code calls ``trace_activation(name, x)`` at module boundaries; while
an ``ActivationTracer`` is open each call records a frame (module path,
abs-min, abs-max, finite) and, on the first non-finite activation, raises
``FloatingPointAbort`` with the recorded module trail, so that the report
names the layer that overflowed. With no tracer open a hook returns its
input before building any tensor operation or syncing with the device, so
the forwards, the streaming CUDA graph and the exported programs are
unchanged. The port runs eagerly, so the abort is raised at the frame's
own call site.

Usage:
    with ActivationTracer() as tracer:
        model(noisy)
    print(tracer.report())

What each route records (the hooks stand where the JAX package has them):
- the layered forward (``scan_mode="layered"``, the default; also
  cIRM-GSN and the shared sub-band model), on the CPU and on the card:
  ``fb/pre_ln``, then for each GSU layer i ``fb/gsu_layer{i}/membrane``
  and ``fb/gsu_layer{i}/spikes``, ``fb/proj``, then the same under
  ``sb{idx}/`` for each section. In eval on the card the membrane frames
  come from kernel F's traced instance (one launch a stack, as untraced),
  on the CPU from F's plain version; in training from kernel D's
  membranes ``y`` (on the CPU D's plain version's);
- the serving routes (``scan_mode="auto"`` in eval: kernels A and B or C),
  the stream-train route, the fused forward on a CPU tensor and
  hop-synchronous streaming record nothing: the JAX package's stream and
  fused forwards call no hook, and its Pallas layered route returns before
  the GSU hooks (``ops/gsu.py:280-293``), so that it records only
  ``pre_ln`` and ``proj``. The port has no such route: its layered forward
  on the card runs F, whose traced instance gives the GSU frames too. (The
  JAX stream path's scan on a CPU records unscoped ``membrane`` frames; the
  port does not reproduce them.) So that an empty trace is not read as a
  clean run, each of these routes calls ``note_untraced_route``: the open
  tracer lists the route in ``untraced_routes``, ``report()`` names it, and
  a warning is logged the first time a tracer meets it.
"""

from __future__ import annotations

import logging
import math
from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

_ACTIVE: Optional["ActivationTracer"] = None
_SCOPES: List[str] = []


@contextmanager
def module_scope(name: str):
    """Prefix trace_activation names with a module path component."""
    _SCOPES.append(name)
    try:
        yield
    finally:
        _SCOPES.pop()


def tracing_active() -> bool:
    """True while an ActivationTracer is open (model code adds its debug
    outputs, the membranes, only then)."""
    return _ACTIVE is not None


def abs_extremes(x: torch.Tensor) -> Tuple[float, float, bool]:
    """(min |x|, max |x|, all finite) with one host sync; NaN propagates
    into both extremes, as ``jnp.min``/``jnp.max`` propagate it."""
    a = x.detach().abs()
    mn, mx, ok = torch.stack([a.min(), a.max(), torch.isfinite(x).all().to(a.dtype)]).tolist()
    return mn, mx, bool(ok)


def trace_activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """Record an activation frame under the open tracer (identity)."""
    tracer = _ACTIVE
    if tracer is None:
        return x
    tracer._record("/".join(_SCOPES + [name]), *abs_extremes(x))
    return x


def trace_extremes(name: str, amin: float, amax: float, finite: bool) -> None:
    """Record a frame whose extremes a kernel reduced itself (kernel F's
    traced instance gives them for the membranes it keeps on chip)."""
    tracer = _ACTIVE
    if tracer is not None:
        tracer._record("/".join(_SCOPES + [name]), float(amin), float(amax), bool(finite))


def note_untraced_route(route: str) -> None:
    """Mark under the open tracer that ``route``, whose code calls no hook,
    ran (see the module docstring); nothing with no tracer open."""
    tracer = _ACTIVE
    if tracer is None or route in tracer.untraced_routes:
        return
    tracer.untraced_routes.append(route)
    logger.warning("activation tracer: the %s records no frames; use scan_mode=\"layered\" "
                   "for per-module frames", route)


def extremes_frame(ext: torch.Tensor) -> Tuple[float, float, bool]:
    """One layer's ``[min |c|, max |c|, non-finite count, NaN count]``
    (``gsu_kernels.gsu_stack_eval_x(..., trace=True)``; the extremes skip
    NaN) -> the frame ``abs_extremes`` gives on the whole membrane."""
    mn, mx, bad, nan = ext.tolist()
    if nan > 0:
        return math.nan, math.nan, False
    return mn, mx, bad == 0


class FloatingPointAbort(FloatingPointError):
    pass


class ActivationTracer:
    """Records (module, abs_min, abs_max, finite) frames; aborts on inf/nan."""

    def __init__(self, abort_on_nonfinite: bool = True, trail_frames: int = 24):
        self.abort_on_nonfinite = abort_on_nonfinite
        self.trail_frames = trail_frames
        self.frames: List[Tuple[str, float, float, bool]] = []
        self.untraced_routes: List[str] = []

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("ActivationTracer contexts do not nest")
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return False

    def _record(self, name: str, amin: float, amax: float, ok: bool) -> None:
        self.frames.append((name, amin, amax, ok))
        if self.abort_on_nonfinite and not ok:
            raise FloatingPointAbort(
                f"non-finite activation in module '{name}' "
                f"(abs range [{amin:.3e}, {amax:.3e}])\n"
                f"module trail (most recent last):\n{self.report(self.trail_frames)}")

    def report(self, last: Optional[int] = None) -> str:
        frames = self.frames[-last:] if last else self.frames
        lines = [f"  {'!! ' if not ok else '   '}{name:<48s} abs[{amin:.3e}, {amax:.3e}]"
                 for name, amin, amax, ok in frames]
        lines += [f"  (no frames from the {route})" for route in self.untraced_routes]
        return "\n".join(lines)
