#!/usr/bin/env python3
"""Where a small call of kernels 7 and 8 spends its host time.

    python3 tools/profile_launch.py [--src DIR] [--calls N]

On a machine with one CUDA card.  For each call at the shapes of the
translm fleet's vmapped SGD step (flash attention on q, k, v of (672, 2,
16, 16) fp32, causal; RMSNorm on x (84, 128, 32) fp32 with 84 scale
rows, as the vmap rule hands it over), it prints

* the host wall per call over ``--calls`` back-to-back calls (the card
  finishes each call in a few microseconds, so the wall is the host's),
  beside one PyTorch call computing the same function
  (``scaled_dot_product_attention``; ``F.rms_norm`` with one scale row);
* ``cProfile``'s functions with the most own time per call;
* ``torch.profiler``'s host view: its recorded operations with the most
  self CPU time per call.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (to
compare two trees in one run on one card).  The card's name and power
limit come first.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_us(fn, calls: int) -> float:
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def profile_call(name, fn, lib, calls: int, top: int = 12) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    us, lib_us = host_us(fn, calls), host_us(lib, calls)
    print(f"== {name}: {us:.2f} us a call over {calls} calls "
          f"(library call {lib_us:.2f} us)")
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    print(f"  cProfile, own time a call (top {top}):")
    for (file, line, func), (_, ncalls, tt, ct, _) in rows:
        where = f"{Path(file).name}:{line}" if line else file
        print(f"    {tt / calls * 1e6:8.2f} us own, {ct / calls * 1e6:8.2f} "
              f"us with callees, {ncalls / calls:5.1f} calls  {func} "
              f"({where})")
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = sorted(tp.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(f"  torch.profiler host view, self CPU time a call (top {top}):")
    for e in ev[:top]:
        print(f"    {e.self_cpu_time_total / calls:8.2f} us self, "
              f"{e.cpu_time_total / calls:8.2f} us total, "
              f"{e.count / calls:5.1f} calls  {e.key}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("profile_launch.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}; "
          f"repro_torch from {Path(ops.__file__).parents[2]}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(672, 2, 16, 16, generator=g, device=dev)
               for _ in range(3))
    profile_call("kernel 7, ops.flash_attention (672, 2, 2, 16, 16) fp32",
                 lambda: ops.flash_attention(q, k, v),
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        is_causal=True),
                 args.calls)
    x = torch.randn(84, 128, 32, generator=g, device=dev)
    scale = torch.randn(84, 32, generator=g, device=dev)
    profile_call("kernel 8, ops._RMSNorm (84, 128, 32) fp32, 84 scale rows",
                 lambda: ops._RMSNorm.apply(x, scale, 1e-5, True),
                 lambda: F.rms_norm(x, (32,), weight=scale[0], eps=1e-5),
                 args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
