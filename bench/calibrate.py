#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card at the cell's
own size, many seeds in one process (no measured window):

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --mode program
    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --mode control
    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --mode fault:half_batch

``program``: the cell's set-up (its checked rounds) and the reference's
judgement, as a run makes them (the lower readings).  ``repeat``: the
program's set-up twice on one seed, against itself (its own spread).  ``control``: the
reference put in the program's place at the precision below the
configuration's (the driver's ``control_outputs``).  ``fault:<name>``:
the program with the driver's planted ``fault(name)``.  One JSON line a
seed on standard output, the numbers under their names.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import env, spec

    env.set_cache_dirs(ROOT)
    import torch
    env.fp32_exact(torch)
    cell = spec.load_cell(args.workload)
    config = spec.load_config(cell["config"])
    drv_mod = spec.load_driver(cell["entry"])
    device = torch.device("cuda", 0)
    print(env.card_line(torch), file=sys.stderr, flush=True)
    for s in args.seeds.split(","):
        seed = int(s) % (1 << 63)
        t0 = time.perf_counter()
        details = {}
        if args.mode == "control":
            numbers = drv_mod.control_outputs(cell, config, seed, device,
                                              details)
        elif args.mode == "repeat":
            runs = []
            for _ in range(2):
                drv = drv_mod.Driver(cell, config, seed, device)
                drv.setup()
                drv.close_program()
                runs.append(drv)
            numbers = []
            details = runs[0].repeat_gaps(runs[1])
        else:
            name = args.mode.split(":", 1)[1] if ":" in args.mode else None
            drv = drv_mod.Driver(cell, config, seed, device)
            if name is None:
                drv.setup()
            else:
                with drv_mod.fault(name):
                    drv.setup()
            drv.close_program()
            numbers = drv.check(cell["limits"], details)
        torch.cuda.empty_cache()
        print(json.dumps({"cell": args.workload, "mode": args.mode,
                          "seed": int(s),
                          "seconds": time.perf_counter() - t0,
                          **{n.name: n.value for n in numbers},
                          "details": details}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
