"""The decoder-LM ``Model`` of the JAX package's ``models/model.py``,
for the dense family.

``Model(cfg)`` exposes:

  init(generator, device)                -> params (flat dict)
  forward(params, batch, impl)           -> (logits, aux, last_hidden)
  loss(params, batch)                    -> (scalar, metrics)  [weighted CE]
  init_decode_state(params, batch, seq_len) -> {"kv": KV caches}
  decode_step(params, state, token, pos) -> (logits, state)
  input_specs(shape)                     -> meta-device stand-ins

Parameters are a flat dict whose keys are the JAX tree paths
(``embed``, ``ln_f.scale``, ``w_unembed``, ``layers.attn.wq``, ...);
the layers are stacked on a leading L axis, as the JAX package stacks
them for ``lax.scan``, so ``repro_torch.convert.params_from_jax`` carries
every leaf over unchanged.  The forward pass is a Python loop over the
stacked layers, each under ``torch.utils.checkpoint`` when ``cfg.remat``
is set (the JAX package's ``jax.checkpoint``).

Every RMSNorm goes through kernel 8 (``ops.rmsnorm``) and, with
``impl="kernel"``, attention through kernel 7 (``ops.flash_attention``);
``use_kernel`` is their tri-state (``Model(cfg, use_kernel=False)`` on
the card is the plain twin).  ``impl=None`` resolves by the activations'
device, as ``ops.resolve_use_kernel`` does: ``"kernel"`` on a CUDA
device, ``"chunked"`` on the CPU (the JAX package's ``CharTransformer``
resolves to ``"pallas"`` on a TPU alike).

The MoE, SSM, hybrid, xLSTM, audio and VLM families are not ported yet:
``Model`` raises ``NotImplementedError`` naming their ROADMAP items.

Batch format (integer tokens, -100 = masked label):
  tokens  (B, S)        labels (B, S)
  weights (B,) float32  optional per-example coreset weights (FedCore δ/m)
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import resolve_use_kernel
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_init, init_mlp,
                                       init_rmsnorm, init_stacked, mlp,
                                       rmsnorm)
from repro_torch.models.small import _weighted_ce

IGNORE = -100
Params = Dict[str, torch.Tensor]

# the families the port does not run yet, with their ROADMAP items
_LATER = {"moe": "16b", "ssm": "16c", "hybrid": "16c", "xlstm": "16d",
          "audio": "16e", "vlm": "16e"}


# ---------------------------------------------------------------------------
# transformer layer (dense)
# ---------------------------------------------------------------------------

def _init_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    groups = (("ln1", init_rmsnorm(cfg.d_model, dev)),
              ("attn", attn.init_attention(generator, cfg)),
              ("ln2", init_rmsnorm(cfg.d_model, dev)),
              ("mlp", init_mlp(generator, cfg)))
    return {f"{g}.{k}": v for g, leaves in groups for k, v in leaves.items()}


def _group(p: Params, name: str) -> Params:
    pre = name + "."
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


def _layer_fwd(p: Params, cfg: ModelConfig, x, positions, *, window, impl,
               use_kernel):
    h = rmsnorm(_group(p, "ln1"), x, cfg.norm_eps, use_kernel=use_kernel)
    x = x + attn.multihead_attention(_group(p, "attn"), cfg, h, positions,
                                     causal=True, window=window, impl=impl,
                                     use_kernel=use_kernel)
    h = rmsnorm(_group(p, "ln2"), x, cfg.norm_eps, use_kernel=use_kernel)
    return x + mlp(_group(p, "mlp"), h, cfg.act)


def _layer_decode(p: Params, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                  window, use_kernel):
    h = rmsnorm(_group(p, "ln1"), x, cfg.norm_eps, use_kernel=use_kernel)
    y, cache_k, cache_v = attn.attention_decode(
        _group(p, "attn"), cfg, h, cache_k, cache_v, pos, window=window)
    x = x + y
    h = rmsnorm(_group(p, "ln2"), x, cfg.norm_eps, use_kernel=use_kernel)
    return x + mlp(_group(p, "mlp"), h, cfg.act), cache_k, cache_v


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model:
    def __init__(self, cfg: ModelConfig, use_kernel: Optional[bool] = None):
        self.cfg, self.use_kernel = cfg, use_kernel
        if cfg.family in _LATER:
            raise NotImplementedError(
                f"{cfg.arch_id}: the {cfg.family} family is not ported yet "
                f"(ROADMAP item {_LATER[cfg.family]})")
        if cfg.family != "dense":
            raise ValueError(f"unknown family {cfg.family}")

    def _layers(self, params: Params):
        """Layer i's params (views of the stacked leaves), i = 0 … L−1."""
        keys = [k for k in params if k.startswith("layers.")]
        for i in range(self.cfg.n_layers):
            yield {k[len("layers."):]: params[k][i] for k in keys}

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Params:
        """Draws every leaf on ``generator``'s device (a torch.Generator on
        the card draws yi-9b's 8.8 B parameters there), then puts the
        params on ``device`` (None = the card)."""
        cfg = self.cfg
        dev = resolve_device(device)
        params = {"embed": embed_init(generator, cfg.vocab_size,
                                      cfg.d_model),
                  "ln_f.scale": init_rmsnorm(cfg.d_model,
                                             generator.device)["scale"]}
        if not cfg.tie_embeddings:
            params["w_unembed"] = dense_init(generator, cfg.d_model,
                                             cfg.vocab_size, scale=0.02)
        layers = init_stacked(generator, cfg.n_layers,
                              lambda g: _init_layer(g, cfg))
        params.update({f"layers.{k}": v for k, v in layers.items()})
        return {k: v.to(dev) for k, v in params.items()}

    def _unembed(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["w_unembed"])
        return (h @ w.to(h.dtype)).float()

    def resolve_impl(self, impl: Optional[str], device) -> str:
        """``impl`` or, for None, ``"kernel"`` on a CUDA device and
        ``"chunked"`` on the CPU."""
        if impl is not None:
            return impl
        return "kernel" if resolve_use_kernel(None, device) else "chunked"

    # --------------------------------------------------------------- forward
    def forward(self, params: Params, batch, *, impl: Optional[str] = None):
        """Returns (logits (B,S,V) fp32, aux scalar, last_hidden (B,S,d))."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = params["embed"][tokens.long()]
        positions = torch.arange(x.shape[1], device=x.device)
        impl = self.resolve_impl(impl, x.device)
        uk = self.use_kernel
        for lp in self._layers(params):
            if cfg.remat:
                names = list(lp)

                def body(h, *leaves, names=names):
                    return _layer_fwd(dict(zip(names, leaves)), cfg, h,
                                      positions, window=cfg.attention_window,
                                      impl=impl, use_kernel=uk)
                x = checkpoint(body, x, *lp.values(), use_reentrant=False)
            else:
                x = _layer_fwd(lp, cfg, x, positions,
                               window=cfg.attention_window, impl=impl,
                               use_kernel=uk)
        x = rmsnorm(_group(params, "ln_f"), x, cfg.norm_eps, use_kernel=uk)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._unembed(params, x), aux, x

    # ------------------------------------------------------------------ loss
    def loss(self, params: Params, batch, *, impl: Optional[str] = None):
        """Weighted next-token CE.  Returns (scalar, metrics dict)."""
        logits, aux, _ = self.forward(params, batch, impl=impl)
        total, per_example = _weighted_ce(logits, batch["labels"],
                                          batch.get("weights"))
        loss = total + self.cfg.router_aux_coef * aux
        return loss, {"loss": total, "aux": aux,
                      "per_example_loss": per_example}

    # -------------------------------------------------------- decode state
    def init_decode_state(self, params: Params, batch: int, seq_len: int,
                          dtype=torch.bfloat16):
        """Zero KV caches (L, B, S_cache, Hk, hd) on the params' device."""
        return {"kv": attn.init_kv_cache(self.cfg, self.cfg.n_layers, batch,
                                         seq_len, dtype,
                                         params["embed"].device)}

    # ---------------------------------------------------------- decode step
    def decode_step(self, params: Params, state, token: torch.Tensor, pos):
        """token: (B, 1) integers; pos: the token's position (an int) ->
        (logits (B,1,V) fp32, state).  The caches are written in place;
        the state returned holds the same tensors."""
        cfg = self.cfg
        x = params["embed"][token.long()]
        kv = state["kv"]
        for i, lp in enumerate(self._layers(params)):
            x, _, _ = _layer_decode(lp, cfg, x, kv["k"][i], kv["v"][i], pos,
                                    window=cfg.attention_window,
                                    use_kernel=self.use_kernel)
        h = rmsnorm(_group(params, "ln_f"), x, cfg.norm_eps,
                    use_kernel=self.use_kernel)
        return self._unembed(params, h), state

    # ------------------------------------------------------------ input specs
    def input_specs(self, shape: ShapeConfig, dtype=torch.bfloat16):
        """Meta-device tensors of every model input's shape and dtype, as
        the JAX package's ``ShapeDtypeStruct`` stand-ins (``dtype`` is
        the float dtype of the audio / VLM inputs, which the dense family
        has none of)."""
        b, s = shape.global_batch, shape.seq_len

        def spec(shp, dt):
            return torch.empty(shp, dtype=dt, device="meta")

        if shape.kind in ("train", "prefill"):
            specs = {"tokens": spec((b, self._text_len(s)), torch.int32),
                     "labels": spec((b, self._text_len(s)), torch.int32)}
            if shape.kind == "train":
                specs["weights"] = spec((b,), torch.float32)
            return specs
        # decode: one token + position
        return {"token": spec((b, 1), torch.int32),
                "pos": spec((), torch.int32)}

    def _text_len(self, s: int) -> int:
        """Text tokens of a sequence of ``s``: all of them in the dense
        family (the audio and VLM families' prefixes come with 16e)."""
        return s
