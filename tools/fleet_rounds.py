#!/usr/bin/env python3
"""Time the CNN fleet's rounds (``chip_smoke.py``'s phase 6 main path) for
one tree of the port, so that two trees can be compared on one card.

    python3 tools/fleet_rounds.py [--src DIR] [--bare N] [--json FILE]

On a machine with one CUDA card.  Runs ``run_fleet(engine="batched")`` on
the full-width SmallCNN over phase 6's 200 pseudo-MNIST clients for 3
rounds with recording on (round walls, the wall by span, the selection
share of the rounds after the first), then ``--bare`` more one-round
runs without recording (their walls), and prints a SHA-256 of the final
parameters: two trees whose kernels give the same bits print the same
digest.  ``--src`` imports ``repro_torch`` from another checkout's
``src`` (run parent, change, change, parent in one call).  TF32 is off
and cuDNN deterministic, as in ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--bare", type=int, default=3)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("fleet_rounds.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.fed.fleet import run_fleet
    from repro_torch.kernels import _build, ops

    chip_smoke.setup_torch()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    tree = str(Path(ops.__file__).parents[2])
    print(f"card: {card}; torch {torch.__version__}; repro_torch from "
          f"{tree}", flush=True)
    print(f"built in {_build.build_all():.1f} s", flush=True)

    wl = chip_smoke.cnn_fleet_workload()
    clients = wl.make_clients()
    specs, cfg, groups = chip_smoke.fleet_setup(wl, clients)
    chip_smoke.log_groups(groups)
    out, _, records, launches, wall = chip_smoke.run_fleet_recorded(
        wl, clients, specs, cfg, 3, "batched")
    sel_s, round_s = chip_smoke.report_fleet_rounds(records)
    rounds = [r["dur"] for r in records
              if r["kind"] == "span" and r["name"] == "round"]
    digest = hashlib.sha256(b"".join(
        out["params"][k].detach().cpu().numpy().tobytes()
        for k in sorted(out["params"]))).hexdigest()
    print(f"wall {wall:.3f} s; selection {100 * sel_s / round_s:.1f}% of "
          f"the rounds after the first; launches {launches}; params "
          f"sha256 {digest[:16]}", flush=True)
    bare = []
    for _ in range(args.bare):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_fleet(wl, clients, specs, cfg, 1, straggler_pct=30.0)
        torch.cuda.synchronize()
        bare.append(time.perf_counter() - t0)
    print("bare one-round walls s: " + ", ".join(f"{b:.3f}" for b in bare),
          flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "tree": tree, "round_walls_s": rounds,
             "selection_share": sel_s / round_s, "bare_walls_s": bare,
             "params_sha256": digest, "launches": launches}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
