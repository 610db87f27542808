"""Small sizes of the benchmark's configurations for the CPU checks."""
import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import spec  # noqa: E402

SMALL = {
    # 10 clients, stragglers on both sides of a cutover moved to M = 32
    "smallcnn-1000": dict(clients=10, mean_samples=24.0, std_samples=30.0,
                          materialize_below=32),
    # Yi-9B's layer structure at toy widths (a head of 64, which the
    # port's fp32 attention kernel takes on the card)
    "yi-9b-d4": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                     d_head=64, d_ff=512, vocab_size=512),
}


def small_config(cell_name: str):
    cell = spec.load_cell(cell_name)
    cfg = spec.load_config(cell["config"])
    cfg.update(SMALL[cell["config"]])
    return cell, cfg


def run_cell(cell_name: str, seed: int, device="cpu", trace: int = 0,
             fault=None):
    """Drive ``bench/run.py``'s run at the small size; returns (exit code,
    the result line or None, standard error)."""
    from bench.run import run
    cell, cfg = small_config(cell_name)
    drv = spec.load_driver(cell["entry"])
    args = argparse.Namespace(workload=cell_name, seed=seed, seconds=0.0,
                              trace=trace)
    out, err = io.StringIO(), io.StringIO()
    ctx = drv.fault(fault) if fault else contextlib.nullcontext()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            ctx:
        rc = run(args, device=device, config=cfg)
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.getvalue()
