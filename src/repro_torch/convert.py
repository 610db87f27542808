"""Convert parameters between the JAX package's trees and the port's dicts.

The JAX package keeps parameters as (nested) dicts of arrays; the port
keeps flat ``dict[str, Tensor]`` whose keys are the tree paths joined
with ``.`` (``lstm0.wx``).  Every leaf carries over unchanged except
SmallCNN's convolution kernels, which JAX stores HWIO and PyTorch OIHW.
The tests run both packages on the same weights through these; the
port imports no JAX, so the trees here hold numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

def _conv_keys(model_name: str):
    """The HWIO convolution kernels of ``model_name`` (SmallCNN's)."""
    return (("conv1", "conv2") if model_name.lower() in ("cnn", "smallcnn")
            else ())


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def params_from_jax(model_name: str, tree: Mapping,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """JAX param tree of numpy arrays -> the port's flat float32 dict.

    ``model_name`` names the model (``"cnn"`` / ``"SmallCNN"`` transpose
    their HWIO convolution kernels to OIHW; every other model maps leaf
    for leaf)."""
    dev = resolve_device(device)
    conv = _conv_keys(model_name)
    out = {}
    for k, v in _flatten(tree).items():
        if k in conv:
            v = np.transpose(v, (3, 2, 0, 1))          # HWIO -> OIHW
        out[k] = torch.tensor(np.ascontiguousarray(v), dtype=torch.float32,
                              device=dev)
    return out


def params_to_jax(model_name: str,
                  params: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``params_from_jax``: a nested dict of numpy arrays
    laid out as the JAX package's ``init`` lays it out."""
    conv = _conv_keys(model_name)
    tree: Dict = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy()
        if k in conv:
            # OIHW -> HWIO
            a = np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree
