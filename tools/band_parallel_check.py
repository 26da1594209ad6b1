"""Band-parallel sub-bands on several cards over NCCL, held against one
process: the counterpart of ``__graft_entry__.dryrun_multichip``.

    python3 tools/band_parallel_check.py [--ranks 4] [--band 2]

Run from the repository's root on a machine with ``--ranks`` cards. Starts
``--ranks`` processes with torchrun's variables, rank r on cuda:r, laid out
as a (ranks / band, band) ``("data", "band")`` mesh (``parallel.make_mesh``).
Each data rank takes its 8 x 2 s utterances of one batch made from a seed;
the ranks of its band group split each sub-band section's units. Each rank
runs flagship M at full width (``models/presets.flagship_m(scan_mode=
"fused", data_axis="data", band_axis="band")``: fb 320 x 2, sb 224 x 2, df
5/3/1, N = 8/3/2 units) through one eval forward and one step of
``dryrun_multichip``'s (value and gradient of freq_mae + mag_mae + 0.001
(100 - si_snr), clip at 10, AdamW 1e-3), its sections' BN statistics summed
over the band group at every step by kernels D and E in band mode, its
gradients summed over the band group and averaged over the data group.
Each rank on a card of its own, every pair with peer access, the band
groups take the peer route (``parallel/mesh.band_route``): kernels D and E
in band mode swap BN's sums with the group's other cards over peer memory
inside one launch a layer, and the check requires that route and no
collective while D and E band run. This process then runs each data
shard's rows unsharded on cuda:0 and holds every rank against it;
``chip_smoke.band_ranks_run`` does both and says what it checks (phase 16
(b) of ``chip_smoke.py`` runs it with two gloo ranks on one card, the
staged route).

Prints the card's name and power limit, each rank's route, its ms for the
eval forward and the step (CUDA events; the step by the host clock after a
synchronise; on the peer route later steps too, as built and with the
host waiting for every band launch, in turn), the collectives a step and inside D and E band, each band
launch's ms in the step, the launches of D, E, their band modes and F, and
one JSON line. Exits non-zero when a check or a rank fails, and 2 with
fewer cards than ranks or a band that does not divide them.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--band", type=int, default=2, help="ranks a band group")
    args = parser.parse_args(argv)
    if torch.cuda.device_count() < args.ranks or args.ranks % args.band:
        print(f"band_parallel_check: {args.ranks} ranks in band groups of {args.band} need "
              f"{args.ranks} cards and a band that divides them; {torch.cuda.device_count()} "
              f"cards found", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from spiking_fullsubnet_torch.ops import gsu_kernels as gk
    cs.log(f"[card] {cs.card_name()} x {torch.cuda.device_count()}")
    cs.log(f"[build] {gk.build_kernels():.1f} s")
    torch.set_grad_enabled(True)
    work = Path(tempfile.mkdtemp(prefix="band_parallel_check_"))
    t0 = time.perf_counter()
    try:
        out = cs.band_ranks_run(work, args.ranks, args.band, "nccl", "cuda",
                                torch.device("cuda", 0), f"{args.ranks} NCCL ranks",
                                route="peer")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out.update(args=vars(args), seconds=time.perf_counter() - t0, card=cs.card_name())
    for rec in out["ranks"]:
        cs.log(f"[band] rank {rec['rank']} on {rec['device']} (data, band) "
               f"{tuple(rec['coordinate'])}, route {rec['route']}: eval {rec['eval_ms']:.1f} ms, "
               f"step {rec['step_ms']:.1f} ms, collectives a step {rec['collectives']} (inside D "
               f"and E band {rec['collectives_inside_band']}), band launches' ms "
               f"{rec['band_launch_ms']}, launches eval {rec['eval_launches']}, step "
               f"{rec['step_launches']}")
    cs.log(f"[band] unsharded on cuda:0: eval {out['reference']['eval_ms']:.1f} ms, step "
           f"{out['reference']['step_ms']:.1f} ms; against it {out['by_rank']}; "
           f"{out['seconds']:.1f} s")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
