#!/usr/bin/env python3
"""Time the k-medoids kernels over a stored D (kernels 2 and 3) at
``chip_smoke.py``'s phase-2 shapes, against another tree's kernels in the
same process.

    python3 tools/kmedoids_times.py [--src OTHER/src] [--sync LANE.json]
                                    [--json FILE]

On a machine with one CUDA card.  Each case is one of phase 2's kernel 2
or kernel 3 cases: the old shapes (C = 1 and 4 at M = 37, 1000, 2048;
one-hot K = 1, 7, 130, 700), D and H off a 16-byte boundary, an H that
is not one-hot, one slot holding 90 % of the rows, and every fleet group
below the distance-free cutover; with ``--sync`` also the sync path's
(M, K) that ``chip_smoke.py``'s phase 3 recorded (its sync lane's
``build/chip_smoke/sync_cnn.json``).  For each it prints the wrapper's
time a call (CUDA events over back-to-back calls), the card's busy time a
call and the kernels' own device time a call (``torch.profiler``, 20
calls), with this tree's kernel 3 by pass (slot lists, walk, segments),
and checks the result against the plain version bit for bit.  With
``--src`` it also builds another checkout's kernels (as
``tools/from_feats_times.py`` does) and calls its entry points as its
wrapper did, on the same inputs, timed in turns (other, this, this,
other).  ``--json`` writes the numbers.  TF32 is off.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from from_feats_times import compare_main  # noqa: E402

KERNELS = ("build_cost", "delta_sweep")
# this tree's passes, timed one by one (a call's device time by pass)
PASSES = {"build_cost": ("build_cost_walk",),
          "delta_sweep": ("delta_sweep_slots", "delta_sweep_walk",
                          "delta_sweep_segments")}


def other_call(build, name: str, inputs):
    """A call of the other tree's kernel ``name`` on ``inputs`` as that
    tree's wrapper makes it: the outputs, and for a kernel 3 that takes
    them (this tree's form) the slot lists' scratch, one launch."""
    import torch

    fn = build.kernel_function(name)
    D = inputs[0]
    c, m = D.shape[:2]
    dev = D.device
    if name == "build_cost":
        outs = (torch.empty((c, m), device=dev),)
        args = [*inputs, *outs]
        dims = (c, m)
    else:
        k = inputs[-1].shape[-1]
        outs = (torch.empty((c, m), device=dev),
                torch.empty((c, m, k), device=dev))
        args = [*inputs, *outs]
        dims = (c, m, k)
        if len(fn.argtypes) > len(args) + len(dims) + 1:
            args += [torch.empty(c * k * m, dtype=torch.int32, device=dev),
                     torch.empty(c * k, dtype=torch.int32, device=dev)]
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*[t.data_ptr() for t in args], *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{name} (other tree) failed: cudaError {rc}")
    return outs


def cases(dev, sync_json):
    """(kernel, label, run(use_kernel) -> outputs, inputs) of the kernel 2
    and 3 cases of ``chip_smoke.kernel_cases`` and, from ``sync_json``,
    of ``chip_smoke.sync_cases``; a case's inputs are its ``run``'s
    default arguments, in the order of the entry points'."""
    import chip_smoke

    all_cases = chip_smoke.kernel_cases(dev, *chip_smoke.phase2_groups(dev))
    if sync_json:
        shapes = json.loads(Path(sync_json).read_text())["sync_shapes"]
        all_cases += chip_smoke.sync_cases(
            dev, [tuple(s) for s in shapes])
    return [(name, label, run, list(run.__defaults__))
            for name, label, _, run, *_ in all_cases if name in KERNELS]


if __name__ == "__main__":
    sys.exit(compare_main(
        __doc__, lambda dev, args: cases(dev, args.sync), other_call,
        lambda name: name, lambda name: PASSES[name],
        lambda ap: ap.add_argument("--sync", default=None)))
