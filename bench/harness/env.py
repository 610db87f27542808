"""The process around a run: cache directories inside the checkout, the
precision the configurations state, the card check and the check that
nothing of JAX or of the JAX package was loaded."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List

# whole top-level module names that no run may load: JAX, its libraries
# and the JAX package the port was made from (``repro_torch`` begins with
# ``repro``, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its CUDA kernels under ``build/repro_torch_kernels``
    of the checkout by itself; Triton's and torch's extension caches are
    pointed beside it, and JAX's Flax loading is kept off."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def fp32_exact(torch) -> None:
    """float32 products and convolutions in float32 (TF32 off), as every
    configuration of this benchmark states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_on(torch) -> None:
    """The control's precision: TF32 for float32 products and
    convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def card_problem(torch, chips: int) -> str:
    """'' when ``chips`` CUDA cards are there, else what is missing."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    n = torch.cuda.device_count()
    if n < chips:
        return f"the cell needs {chips} CUDA devices, {n} found"
    return ""


def forbidden_loaded() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line(torch) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    name = torch.cuda.get_device_name(0)
    return f"card: {name}; nvidia-smi: {out[0] if out else 'not read'}"
