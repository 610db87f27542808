"""Build and load the CUDA kernels in ``csrc/`` at their first use.

Each ``.cu`` file has plain C entry points (one per kernel it holds) and
is compiled on its own by ``nvcc`` for ``sm_90a`` into a shared library
under
``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``); the libraries are loaded with ``ctypes``.  All sources
are compiled in parallel, one ``nvcc`` process each.  A library's file
name carries a hash of its source, so an edited kernel is rebuilt and a
built one is reused.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[3]      # the checkout
BUILD_DIR = ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel name -> (source, C entry point, argtypes); every entry point
# returns cudaGetLastError() as an int
KERNELS = {
    "pairwise_l2": ("pairwise_l2.cu", "fedcore_pairwise_l2",
                    [_P] * 5 + [_I] * 5 + [_P]),
    "build_cost": ("build_cost.cu", "fedcore_build_cost",
                   [_P] * 4 + [_I] * 2 + [_P]),
    "delta_sweep": ("delta_sweep.cu", "fedcore_delta_sweep",
                    [_P] * 7 + [_I] * 3 + [_P]),
    "pairwise_l2_batched": ("pairwise_l2.cu", "fedcore_pairwise_l2_batched",
                            [_P] * 3 + [_I] * 5 + [_P]),
    "build_cost_from_feats": ("kmedoids_from_feats.cu",
                              "fedcore_build_cost_from_feats",
                              [_P] * 5 + [_I] * 3 + [_P]),
    "delta_sweep_from_feats": ("kmedoids_from_feats.cu",
                               "fedcore_delta_sweep_from_feats",
                               [_P] * 8 + [_I] * 4 + [_P]),
    "flash_attention": ("flash_attention.cu", "fedcore_flash_attention",
                        [_P] * 4 + [_I] * 9 + [_F] + [_P]),
    "rmsnorm": ("rmsnorm.cu", "fedcore_rmsnorm",
                [_P] * 3 + [_I] * 4 + [_F] * 2 + [_P]),
}

_LOADED: Dict[str, object] = {}
# compiler report of the last build: source file -> nvcc/ptxas output
# (registers, shared memory, spills; chip_smoke.py prints it)
BUILD_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    home_nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc")
    if nvcc is None and home_nvcc.exists():
        nvcc = str(home_nvcc)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the repro_torch CUDA kernels are "
                           "built with the CUDA toolkit's nvcc")
    return nvcc


def _library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build_all(nvcc: Optional[str] = None) -> float:
    """Compile every kernel whose library is missing, in parallel.

    Returns the wall seconds spent building (0.0 when all were built)."""
    todo = {src: _library_path(src) for src, _, _ in KERNELS.values()
            if not _library_path(src).exists()}
    if not todo:
        return 0.0
    nvcc = nvcc or find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src, lib in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib, cmd)
    failed = []
    for src, (proc, tmp, lib, cmd) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[src] = out
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, lib)   # atomic: concurrent builders race safely
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def kernel_function(name: str):
    """The ctypes entry point of kernel ``name``, built on first use."""
    fn = _LOADED.get(name)
    if fn is None:
        build_all()
        source, symbol, argtypes = KERNELS[name]
        lib = ctypes.CDLL(str(_library_path(source)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return fn
