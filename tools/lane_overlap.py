#!/usr/bin/env python3
"""Whether a lane of ``chip_smoke.py`` stretches another's phases when the
two run together: runs ``BASE`` alone and ``BASE`` beside ``EXTRA`` in
turns (alone, together, together, alone), on the card, and prints each
run's phase seconds and each phase's ratio together / alone.

    python3 tools/lane_overlap.py [BASE [EXTRA]]

(defaults: ``lm_families`` and ``dryrun``).  Run from the root of a
checkout on a machine with one CUDA card; the kernels are built first,
each lane's log is under ``build/chip_smoke/``.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402


def main(base: str = "lm_families", extra: str = "dryrun") -> int:
    import torch

    if not torch.cuda.is_available():
        print("lane_overlap.py: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.setup_torch()
    from repro_torch.kernels import _build

    print(f"card: {chip_smoke.card_line()}", flush=True)
    print(f"kernels built in {_build.build_all():.2f} s", flush=True)
    chip_smoke.LANE_DIR.mkdir(parents=True, exist_ok=True)
    runs = []
    for lanes in ((base,), (base, extra), (base, extra), (base,)):
        chip_smoke.T0 = time.time()
        _, phases, _ = chip_smoke.run_lanes(lanes)
        wall = time.time() - chip_smoke.T0
        runs.append((lanes, phases, wall))
        print(json.dumps({"lanes": lanes, "wall_s": wall,
                          "phases": phases}), flush=True)
    alone = [p for lanes, p, _ in runs if len(lanes) == 1]
    together = [p for lanes, p, _ in runs if len(lanes) == 2]
    for key in alone[0]:
        a = sum(p[key] for p in alone) / len(alone)
        t = sum(p[key] for p in together) / len(together)
        print(f"{key}: alone {a:.2f} s, beside {extra} {t:.2f} s, "
              f"ratio {t / a:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
