#!/usr/bin/env python3
"""Disassemble the PyTorch port's CUDA kernels and summarise their SASS.

    python3 tools/kernel_sass.py

Builds the libraries of ``src/repro_torch/kernels/csrc`` as their first
launch would (nvcc, sm_90a), runs ``cuobjdump -sass`` on each and prints,
per kernel function: its instruction count, the counts of the opcodes
that move data (LDG, LDGSTS for cp.async, STG, LDS, STS), do fp32
arithmetic (FADD, FMUL, FFMA, FMNMX, MUFU) or synchronise (BAR), and for
each loop (a backward branch) its length and the order of its loads,
stores, barriers and arithmetic, run lengths folded (``LDG x4 STS x4 BAR``).  A staging loop
whose global loads each wait for the shared store before them shows
there as alternating ``LDG STS``.  The full listings go to
``chiprun_out/sass/``.  ``fused_in_sum_loops`` finds the FFMAs in a
kernel's k-loops (``chip_smoke.py`` holds the pairwise kernel to none).
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

COUNTED = ("LDG", "LDGSTS", "STG", "LDS", "STS", "FADD", "FMUL", "FFMA",
           "FMNMX", "MUFU", "BAR")
INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
BRANCH = re.compile(r"\bBRA\s+`?\(?(\.L_x_\d+|0x[0-9a-f]+)")


def functions(sass: str):
    """{function name: [(address, opcode, line)]} and each function's
    {label: instruction index}."""
    out, labels, name = {}, {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            out[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        lab = LABEL.match(line)
        if lab:
            labels[name][lab.group(1)] = len(out[name])
            continue
        ins = INSN.search(line)
        if ins:
            out[name].append((int(ins.group(1), 16), ins.group(2), line))
    return out, labels


def folded(ops):
    runs = []
    for op in ops:
        if runs and runs[-1][0] == op:
            runs[-1][1] += 1
        else:
            runs.append([op, 1])
    return " ".join(op if n == 1 else f"{op} x{n}" for op, n in runs)


def loops(insns, labels):
    """(start, end) instruction indices of each loop of one function: the
    span from a backward branch's target to the branch."""
    at = {addr: i for i, (addr, _, _) in enumerate(insns)}
    out = []
    for i, (_, op, line) in enumerate(insns):
        br = BRANCH.search(line) if op.startswith("BRA") else None
        if br is None:
            continue
        tgt = br.group(1)
        start = (labels.get(tgt) if tgt.startswith(".L")
                 else at.get(int(tgt, 16)))
        if start is not None and start <= i:
            out.append((start, i))
    return out


def summarise(name, insns, labels):
    base = Counter(op.split(".")[0] for _, op, _ in insns)
    print(f"{name}: {len(insns)} instructions; " + ", ".join(
        f"{op} {base[op]}" for op in COUNTED if base[op]))
    for start, i in loops(insns, labels):
        body = [o.split(".")[0] for _, o, _ in insns[start:i + 1]]
        shown = [o for o in body if o in COUNTED]
        print(f"  loop [{start}, {i}] {i - start + 1} instructions: "
              f"{folded(shown)}")


def fused_in_sum_loops(sass: str, match: str):
    """{function: [FFMA count of each loop]} for each function whose
    name holds ``match``, over its loops that read shared memory and add
    in fp32, by FADD or FFMA (a k-loop).  A kernel whose contract is a
    rounded product and a rounded add per term must show no FFMA there;
    an empty list means no such loop was found."""
    funcs, labels = functions(sass)
    out = {}
    for name, insns in funcs.items():
        if match not in name:
            continue
        out[name] = []
        for start, end in loops(insns, labels):
            body = Counter(o.split(".")[0] for _, o, _ in
                           insns[start:end + 1])
            if body["LDS"] and (body["FADD"] or body["FFMA"]):
                out[name].append(body["FFMA"])
    return out


def disassemble(source: str) -> str:
    """``cuobjdump -sass`` of the built library of one ``csrc`` source
    (built first if it is not)."""
    from repro_torch.kernels import _build

    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build.find_nvcc()).with_name("cuobjdump"))
    _build.build_all()
    return subprocess.run([cuobjdump, "-sass",
                           str(_build._library_path(source))], check=True,
                          capture_output=True, text=True).stdout


def main() -> int:
    from repro_torch.kernels import _build

    out = ROOT / "chiprun_out" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    for src in sorted({src for src, _, _ in _build.KERNELS.values()}):
        sass = disassemble(src)
        (out / f"{Path(src).stem}.sass").write_text(sass)
        print(f"== {src} ({_build._library_path(src).name})")
        funcs, labels = functions(sass)
        for name, insns in funcs.items():
            summarise(name, insns, labels[name])
    return 0


if __name__ == "__main__":
    sys.exit(main())
