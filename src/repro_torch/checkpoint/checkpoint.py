"""npz checkpoints of the port's trees, in the JAX package's file format.

A checkpoint is one ``.npz`` per tree: each leaf under its tree path (the
path parts joined with ``/``; ``#i`` for a sequence index), in the order
``jax.tree_util`` flattens (dict keys sorted), plus a JSON structure
descriptor under the reserved ``__treedef__`` key (containers dict /
list / tuple / None), so ``load_pytree`` without ``like`` rebuilds the
exact containers and leaf dtypes.  Trees with namedtuples or non-string
dict keys are saved without the descriptor and load exactly with
``like``.  The port's flat param dicts (keys ``lstm0.wx``) are one dict
level: the descriptor rejects only ``/`` and a leading ``#`` in a key.

The port's leaves are tensors; they go to disk as numpy arrays
(``t.detach().cpu().numpy()``), and load as tensors: with ``like`` each
leaf takes its template leaf's dtype and device, without it the saved
dtype (numpy keeps int64 and float64) on ``device``.  So a checkpoint
the JAX package wrote loads here, and one written here loads there
(``repro_torch.convert`` maps SmallCNN's convolution layouts).

Server state is a ``ckpt_NNNNNN.npz`` and ``ckpt_NNNNNN.json`` pair.
Both files are written to a temp file and renamed into place, the meta
first, so a complete npz always has its meta; ``latest_checkpoint``
skips npz files that cannot be read.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_SEP = "/"
_TREEDEF_KEY = "__treedef__"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """(path part, child) of a container in ``jax.tree_util``'s flatten
    order, or None for a leaf (None is an empty container)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"#{i}", v) for i, v in enumerate(tree)]
    return None


def _join(prefix: str, part: str) -> str:
    return part if not prefix else f"{prefix}{_SEP}{part}"


def _leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for part, child in kids:
        yield from _leaves_with_paths(child, _join(prefix, part))


def _map_with_paths(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, the
    containers (and dict key order) kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, _join(prefix, str(k)))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_paths(fn, getattr(tree, f),
                                            _join(prefix, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, _join(prefix, f"#{i}"))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaves_with_paths(tree)}


def _treedef_desc(tree) -> Optional[Dict[str, Any]]:
    """JSON-able structure descriptor, or None when the tree holds a node
    the path encoding cannot round-trip (then ``like`` is needed at load
    time)."""
    if tree is None:
        return {"kind": "none"}
    if isinstance(tree, dict):
        keys = list(tree.keys())
        if any(not isinstance(k, str) or _SEP in k or k.startswith("#")
               for k in keys):
            return None
        children = {}
        for k in keys:
            d = _treedef_desc(tree[k])
            if d is None:
                return None
            children[k] = d
        return {"kind": "dict", "children": children}
    if _is_namedtuple(tree):
        return None  # a plain-tuple rebuild would change its type
    if isinstance(tree, (list, tuple)):
        children = []
        for v in tree:
            d = _treedef_desc(v)
            if d is None:
                return None
            children.append(d)
        return {"kind": "list" if isinstance(tree, list) else "tuple",
                "children": children}
    return {"kind": "leaf"}


def _rebuild(desc: Dict[str, Any], flat: Dict[str, np.ndarray],
             prefix: str, device: torch.device):
    kind = desc["kind"]
    if kind == "none":
        return None
    if kind == "leaf":
        return torch.as_tensor(flat[prefix], device=device)
    if kind == "dict":
        return {k: _rebuild(d, flat, _join(prefix, k), device)
                for k, d in desc["children"].items()}
    seq = [_rebuild(d, flat, _join(prefix, f"#{i}"), device)
           for i, d in enumerate(desc["children"])]
    return seq if kind == "list" else tuple(seq)


def _write_atomic(path: str, write) -> None:
    """``write(file)`` into a temp file beside ``path``, then rename it
    onto ``path``."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_pytree(path: str, tree) -> None:
    flat = _flatten(tree)
    desc = _treedef_desc(tree)
    if desc is not None:
        flat[_TREEDEF_KEY] = np.array(json.dumps(desc))
    _write_atomic(path, lambda f: np.savez(f, **flat))


def load_pytree(path: str, like=None, device: DeviceLike = None):
    """Load a tree of tensors.  With ``like``, its exact structure, each
    leaf with the dtype and device of its template leaf (a template leaf
    that is no tensor gives the saved dtype on ``device``); without it,
    the saved ``__treedef__`` descriptor's containers and dtypes on
    ``device``, or nested dicts for a file without one."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != _TREEDEF_KEY}
        desc_raw = (str(data[_TREEDEF_KEY])
                    if _TREEDEF_KEY in data.files else None)
    if like is not None:
        def restore(p, leaf):
            if isinstance(leaf, torch.Tensor):
                return torch.as_tensor(flat[p]).to(dtype=leaf.dtype,
                                                   device=leaf.device)
            return torch.as_tensor(flat[p], device=resolve_device(device))
        return _map_with_paths(restore, like)
    dev = resolve_device(device)
    if desc_raw is not None:
        return _rebuild(json.loads(desc_raw), flat, "", dev)
    # legacy files: nested dicts from the path encoding
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(val, device=dev)
    return out


def _readable_npz(path: str) -> bool:
    try:
        with np.load(path, allow_pickle=False) as data:
            data.files
        return True
    except Exception:
        return False


def latest_checkpoint(directory: str, prefix: str = "ckpt_"
                      ) -> Optional[str]:
    """The newest *complete* checkpoint: partly written or corrupt npz
    files (a crash while copying onto the target name) are skipped, so a
    resume never trips over a torn file."""
    if not os.path.isdir(directory):
        return None
    candidates = []
    for name in os.listdir(directory):
        m = re.fullmatch(rf"{re.escape(prefix)}(\d+)\.npz", name)
        if m:
            candidates.append((int(m.group(1)), os.path.join(directory, name)))
    for _, path in sorted(candidates, reverse=True):
        if _readable_npz(path):
            return path
    return None


def save_server_state(directory: str, round_idx: int, params,
                      extra: Optional[Dict[str, Any]] = None,
                      prefix: str = "ckpt_") -> str:
    """An atomic {params npz + JSON meta} pair.  The meta sidecar is
    renamed into place *before* the npz, so a complete npz always has its
    meta: a crash in between leaves only an orphan json that
    ``latest_checkpoint`` never selects."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}{round_idx:06d}.npz")
    meta_path = os.path.join(directory, f"{prefix}{round_idx:06d}.json")
    meta = {"round": round_idx, **(extra or {})}
    _write_atomic(meta_path,
                  lambda f: f.write(json.dumps(meta).encode("utf-8")))
    save_pytree(path, params)
    return path


def load_server_state(directory: str, like=None, prefix: str = "ckpt_",
                      device: DeviceLike = None
                      ) -> Tuple[Optional[Any], int]:
    """(params, round) of the latest complete checkpoint, or (None, -1);
    ``like`` and ``device`` as in ``load_pytree``."""
    path = latest_checkpoint(directory, prefix)
    if path is None:
        return None, -1
    params = load_pytree(path, like, device)
    meta_path = path[:-len(".npz")] + ".json"
    round_idx = -1
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            round_idx = json.load(f).get("round", -1)
    return params, round_idx


def load_server_meta(directory: str, prefix: str = "ckpt_"
                     ) -> Optional[Dict[str, Any]]:
    """The JSON meta of the latest complete checkpoint (the ``extra``
    payload the runtimes keep their scheduler, RNG and event-loop state
    in), or None without a checkpoint or its meta."""
    path = latest_checkpoint(directory, prefix)
    if path is None:
        return None
    meta_path = path[:-len(".npz")] + ".json"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)
