#!/usr/bin/env python3
"""Time the distance-free k-medoids kernels (kernels 5 and 6) at
``chip_smoke.py``'s phase-2 shapes, against another tree's kernels in the
same process.

    python3 tools/from_feats_times.py [--src OTHER/src] [--json FILE]

On a machine with one CUDA card.  Each case is one of phase 2's kernel 5
or kernel 6 cases: C = 4, M = 512 (also with padded rows) and C = 1,
M = 2048 at SmallCNN's F = 1568, the CNN fleet's (22, 256) group, and
every selection group of the char-LM fleets at or above the cutover
(F = 32).  For each it prints the wrapper's time a call (CUDA events over
back-to-back calls), the card's busy time a call and the kernels' own
device time a call (``torch.profiler``, 20 calls; the busy time adds the
wrapper's squared norms), with this tree's by pass, and checks the
result against the plain version bit for bit.  With ``--src`` it also builds the kernels of
another checkout's ``src`` (its ``repro_torch/kernels/_build.py``, loaded
on its own) and calls its entry points as its wrapper did, on the same
inputs, timed in turns (other, this, this, other), so that two trees are
compared on one card in one process.  ``--json`` writes the numbers.  TF32
is off.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from pairwise_tiles import device_ms, events_ms  # noqa: E402

KERNEL_MATCH = "from_feats"     # both trees' kernels 5 and 6 hold it
# this tree's passes, timed one by one (a call's device time by pass)
PASSES = ("from_feats_distances", "from_feats_column_walk",
          "from_feats_sweep_product")


def other_build(src: str):
    """The other tree's ``_build`` module, loaded on its own under another
    name: it builds that tree's sources into that tree's build directory
    and resolves its entry points with its own argument types."""
    path = Path(src).resolve() / "repro_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_call(build, name: str, inputs):
    """A call of the other tree's kernel ``name`` on ``inputs`` as that
    tree's wrapper makes it: the squared norms, the outputs, one launch.
    An entry point without a workspace takes (x, sq, rows..., outputs...,
    C, M, F[, K], stream); one of this tree's form also a workspace and
    one piece, the whole cohort."""
    import torch

    from repro_torch.kernels import ops

    fn = build.kernel_function(name)
    x = inputs[0]
    c, m, f = x.shape
    sq = torch.sum(x * x, dim=-1)
    if name == "build_cost_from_feats":
        outs = (torch.empty((c, m), device=x.device),)
        dims = (c, m, f)
    else:
        k = inputs[-1].shape[-1]
        outs = (torch.empty((c, m), device=x.device),
                torch.empty((c, m, k), device=x.device))
        dims = (c, m, f, k)
    ptrs = [t.data_ptr() for t in [x, sq, *inputs[1:], *outs]]
    stream = torch.cuda.current_stream().cuda_stream
    if len(fn.argtypes) == len(ptrs) + len(dims) + 1:
        rc = fn(*ptrs, *dims, stream)
    else:
        ws = torch.empty(c * m * m, device=x.device)
        tile = ops.pairwise_tile(c, m, m, True, ops.card_sms(x.device))
        rc = fn(*ptrs, ws.data_ptr(), *dims, 0, m, tile, stream)
    if rc != 0:
        raise RuntimeError(f"{name} (other tree) failed: cudaError {rc}")
    return outs


def cases(dev):
    """(kernel, label, run(use_kernel) -> outputs, inputs) of the kernel 5
    and 6 cases of ``chip_smoke.kernel_cases``; a case's inputs are its
    ``run``'s default arguments, in the order of the entry points' (x,
    then the (C, M) rows, then the one-hot)."""
    import chip_smoke

    twl, tclients, _, tcfg, tgroups = chip_smoke.translm_fleet()
    _, lm = chip_smoke.selection_groups(twl, tclients, tcfg, tgroups, dev)
    attn = chip_smoke.translm_attention_shapes(tcfg, tgroups)
    return [(name, label, run, list(run.__defaults__))
            for name, label, _, run, *_ in
            chip_smoke.kernel_cases(dev, attn, [], lm)
            if "from_feats" in name]


def compare_main(doc: str, cases_of, call_other, match_of, passes_of,
                 add_args=None) -> int:
    """The command line of this tool and of ``tools/kmedoids_times.py``:
    ``--src``, ``--json`` and the tool's own options (``add_args``); each
    case of ``cases_of(dev, args)`` ((kernel, label, run, inputs)) checked
    against its plain version bit for bit and timed, this tree's kernels
    and, with ``--src``, the other tree's (``call_other(build, kernel,
    inputs)``) in turns; ``match_of(kernel)`` names the kernels' device
    activity, ``passes_of(kernel)`` this tree's passes."""
    tool = Path(sys.argv[0]).name
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--src", default=None)
    ap.add_argument("--json", default=None)
    if add_args is not None:
        add_args(ap)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    other = other_build(args.src) if args.src else None
    if other is not None:
        other.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s; other tree: "
          f"{args.src}", flush=True)
    dev = torch.device("cuda")
    # the first profiler session of a process may see no device activity
    device_ms(lambda: torch.ones(1, device=dev).sum())
    rows = []
    fmt = (lambda v: "not measured" if v is None else f"{v:.4f}")
    for name, label, run, inputs in cases_of(dev, args):
        want = run(False)
        got = run(True)
        row = {"kernel": name, "case": label,
               "exact": all(torch.equal(a, b) for a, b in zip(got, want))}
        this = lambda run=run: run(True)       # noqa: E731
        timed = [("this", this)]
        if other is not None:
            that = lambda name=name, inputs=inputs: call_other(  # noqa
                other, name, inputs)
            row["other_exact"] = all(torch.equal(a, b) for a, b in
                                     zip(that(), want))
            timed = [("other", that), ("this", this), ("this", this),
                     ("other", that)]
        for who, fn in timed:
            r = row.setdefault(who, {"ms": [], "busy_ms": [],
                                     "kernel_ms": []})
            r["ms"].append(events_ms(fn))
            r["busy_ms"].append(device_ms(fn))
            r["kernel_ms"].append(device_ms(fn, match_of(name)))
        row["passes_ms"] = {p: device_ms(this, p) for p in passes_of(name)}
        rows.append(row)
        line = f"{name:22s} {label:32s} exact {row['exact']}"
        for who in ("this", "other"):
            if who in row:
                r = row[who]
                line += (f" | {who}: ms {', '.join(map(fmt, r['ms']))} "
                         f"busy {', '.join(map(fmt, r['busy_ms']))} kernel "
                         f"{', '.join(map(fmt, r['kernel_ms']))}")
        line += " | passes " + ", ".join(
            f"{p.rsplit('_', 1)[-1]} {fmt(v)}" for p, v in
            row["passes_ms"].items() if v is not None)
        if "other_exact" in row:
            line += f" | other exact {row['other_exact']}"
            k_this = [v for v in row["this"]["kernel_ms"] if v]
            k_that = [v for v in row["other"]["kernel_ms"] if v]
            if k_this and k_that:
                line += (f" | other/this kernel "
                         f"{min(k_that) / max(k_this):.2f}-"
                         f"{max(k_that) / min(k_this):.2f}x")
        print(line, flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "other": args.src, "rows": rows}, indent=1))
    bad = [r["case"] for r in rows
           if not r["exact"] or r.get("other_exact") is False]
    if bad:
        print(f"{tool}: a kernel differs from its plain version: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(compare_main(__doc__, lambda dev, args: cases(dev), other_call,
                          lambda name: KERNEL_MATCH,
                          lambda name: PASSES))
