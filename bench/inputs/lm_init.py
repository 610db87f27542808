"""Frozen copy of the port's dense ``Model.init`` draw order
(``repro_torch.models.model``), for a dense decoder with SwiGLU and
untied embeddings: every leaf drawn in turn from one ``torch.Generator``
on the device, float32.

    embed      N(0, 1)·0.02          (V, d)
    w_unembed  N(0, 1)·0.02          (d, V)
    per layer, stacked on a leading axis, in this order:
      mlp.w_gate, mlp.w_up (d, f) · 1/√d;  mlp.w_down (f, d) · 1/√f;
      attn.wq (d, Hq·hd), attn.wk, attn.wv (d, Hk·hd) · 1/√d;
      attn.wo (Hq·hd, d) · 1/√(Hq·hd)
    norms (ln1, ln2 a layer, ln_f) ones.

``bench/tests/check_inputs.py`` holds it to the port's bytes."""
from __future__ import annotations

from typing import Dict

import numpy as np


def _dense(torch, g, d_in, d_out, scale=None):
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=g, dtype=torch.float32,
                       device=g.device) * scale


def init_dense_lm(torch, cfg: Dict, seed: int, device) -> Dict:
    d, f, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    hq, hk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    n = cfg["n_layers"]
    g = torch.Generator(device=device).manual_seed(seed)
    p = {"embed": torch.randn((v, d), generator=g, dtype=torch.float32,
                              device=device) * 0.02,
         "ln_f.scale": torch.ones(d, device=device),
         "w_unembed": _dense(torch, g, d, v, scale=0.02)}

    def layer():
        return {"mlp.w_gate": _dense(torch, g, d, f),
                "mlp.w_up": _dense(torch, g, d, f),
                "mlp.w_down": _dense(torch, g, f, d),
                "attn.wq": _dense(torch, g, d, hq * hd),
                "attn.wk": _dense(torch, g, d, hk * hd),
                "attn.wv": _dense(torch, g, d, hk * hd),
                "attn.wo": _dense(torch, g, hq * hd, d)}

    first = layer()
    stacked = {k: torch.empty((n,) + t.shape, dtype=t.dtype, device=device)
               for k, t in first.items()}
    for k, t in first.items():
        stacked[k][0] = t
    del first
    for i in range(1, n):
        for k, t in layer().items():
            stacked[k][i] = t
    for name in ("ln1.scale", "ln2.scale"):
        stacked[name] = torch.ones((n, d), device=device)
    p.update({f"layers.{k}": t for k, t in stacked.items()})
    return p
