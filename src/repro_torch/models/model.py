"""The decoder-LM ``Model`` of the JAX package's ``models/model.py``,
for the dense, MoE, SSM and hybrid families.

``Model(cfg)`` exposes:

  init(generator, device)                -> params (flat dict)
  forward(params, batch, impl)           -> (logits, aux, last_hidden)
  loss(params, batch)                    -> (scalar, metrics)  [weighted CE]
  init_decode_state(params, batch, seq_len) -> KV caches / Mamba states
  decode_step(params, state, token, pos) -> (logits, state)
  input_specs(shape)                     -> meta-device stand-ins

Parameters are a flat dict whose keys are the JAX tree paths
(``embed``, ``ln_f.scale``, ``w_unembed``, ``layers.attn.wq``,
``layers.moe.router``, ``layers.w_in``, ``shared_attn.attn.wq``, ...);
the layers are stacked on a leading L axis, as the JAX package stacks
them for ``lax.scan``, so ``repro_torch.convert.params_from_jax`` carries
every leaf over unchanged.  The forward pass is a Python loop over the
stacked layers, each under ``torch.utils.checkpoint`` when ``cfg.remat``
is set (the JAX package's ``jax.checkpoint``; for the SSM families only
on the pure-SSM stack, as there).

The ``moe`` family runs ``models/moe.py``'s FFN in each layer and
returns the sum of the layers' load-balance losses as ``aux``.  The
``ssm`` family is a stack of Mamba2 blocks (``models/mamba2.py``); the
``hybrid`` family (zamba2) adds one shared attention layer, applied
after every ``attn_every`` Mamba2 layers to ``concat(h, emb) @
shared_in`` and added to h.

Every RMSNorm goes through kernel 8 (``ops.rmsnorm``) and, with
``impl="kernel"``, attention through kernel 7 (``ops.flash_attention``);
``use_kernel`` is their tri-state (``Model(cfg, use_kernel=False)`` on
the card is the plain twin).  ``impl=None`` resolves by the activations'
device, as ``ops.resolve_use_kernel`` does: ``"kernel"`` on a CUDA
device, ``"chunked"`` on the CPU (the JAX package's ``CharTransformer``
resolves to ``"pallas"`` on a TPU alike).

The xLSTM, audio and VLM families are not ported yet: ``Model`` raises
``NotImplementedError`` naming their ROADMAP items.

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
from repro_torch.models import mamba2, moe
from repro_torch.models.layers import (dense_init, embed_init, init_mlp,
                                       init_rmsnorm, init_stacked, mlp,
                                       rmsnorm, subparams)
from repro_torch.models.small import _weighted_ce

IGNORE = -100
Params = Dict[str, torch.Tensor]

# the families the port does not run yet, with their ROADMAP items
_LATER = {"xlstm": "16d", "audio": "16e", "vlm": "16e"}
_FAMILIES = ("dense", "moe", "ssm", "hybrid")


# ---------------------------------------------------------------------------
# transformer layer (dense or moe)
# ---------------------------------------------------------------------------

def _init_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    ffn = (("moe", moe.init_moe(generator, cfg)) if cfg.n_experts > 0
           else ("mlp", init_mlp(generator, cfg)))
    groups = (("ln1", init_rmsnorm(cfg.d_model, dev)),
              ("attn", attn.init_attention(generator, cfg)),
              ("ln2", init_rmsnorm(cfg.d_model, dev)), ffn)
    return {f"{g}.{k}": v for g, leaves in groups for k, v in leaves.items()}


def _ffn(p: Params, cfg: ModelConfig, h):
    """The layer's FFN on h: (y, the MoE load-balance loss or None)."""
    if cfg.n_experts > 0:
        return moe.moe_ffn(subparams(p, "moe"), cfg, h)
    return mlp(subparams(p, "mlp"), h, cfg.act), None


def _layer_fwd(p: Params, cfg: ModelConfig, x, positions, *, window, impl,
               use_kernel):
    """(x + attention + FFN, the layer's aux or None)."""
    h = rmsnorm(subparams(p, "ln1"), x, cfg.norm_eps, use_kernel=use_kernel)
    x = x + attn.multihead_attention(subparams(p, "attn"), cfg, h, positions,
                                     causal=True, window=window, impl=impl,
                                     use_kernel=use_kernel)
    h = rmsnorm(subparams(p, "ln2"), x, cfg.norm_eps, use_kernel=use_kernel)
    y, aux = _ffn(p, cfg, h)
    return x + y, aux


def _layer_decode(p: Params, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                  window, use_kernel):
    h = rmsnorm(subparams(p, "ln1"), x, cfg.norm_eps, use_kernel=use_kernel)
    y, cache_k, cache_v = attn.attention_decode(
        subparams(p, "attn"), cfg, h, cache_k, cache_v, pos, window=window)
    x = x + y
    h = rmsnorm(subparams(p, "ln2"), x, cfg.norm_eps, use_kernel=use_kernel)
    return x + _ffn(p, cfg, h)[0], cache_k, cache_v


def _remat(fn, x, lp: Params):
    """``fn(lp, x)`` under ``torch.utils.checkpoint``, the layer's leaves
    passed as its inputs."""
    names = list(lp)

    def body(h, *leaves):
        return fn(dict(zip(names, leaves)), h)
    return checkpoint(body, x, *lp.values(), use_reentrant=False)


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
        if cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {cfg.family}")

    @property
    def _hybrid(self) -> bool:
        return self.cfg.family == "hybrid" and bool(self.cfg.attn_every)

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
        params on ``device`` (None = the card).  The SSM families stack
        Mamba2 layers; the hybrid adds the unstacked ``shared_attn``
        layer and ``shared_in`` (2d, d)."""
        cfg = self.cfg
        dev = resolve_device(device)
        params = {"embed": embed_init(generator, cfg.vocab_size,
                                      cfg.d_model),
                  "ln_f.scale": init_rmsnorm(cfg.d_model,
                                             generator.device)["scale"]}
        if not cfg.tie_embeddings:
            params["w_unembed"] = dense_init(generator, cfg.d_model,
                                             cfg.vocab_size, scale=0.02)
        if cfg.family in ("ssm", "hybrid"):
            layers = init_stacked(generator, cfg.n_layers,
                                  lambda g: mamba2.init_mamba2(g, cfg))
            if self._hybrid:
                params.update({f"shared_attn.{k}": v for k, v in
                               _init_layer(generator, cfg).items()})
                params["shared_in"] = dense_init(generator, 2 * cfg.d_model,
                                                 cfg.d_model)
        else:
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
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in ("ssm", "hybrid"):
            x = self._ssm_forward(params, x, positions, impl)
        else:
            def layer(lp, h):
                return _layer_fwd(lp, cfg, h, positions,
                                  window=cfg.attention_window, impl=impl,
                                  use_kernel=uk)
            for lp in self._layers(params):
                x, a = _remat(layer, x, lp) if cfg.remat else layer(lp, x)
                if a is not None:
                    aux = aux + a
        x = rmsnorm(subparams(params, "ln_f"), x, cfg.norm_eps, use_kernel=uk)
        return self._unembed(params, x), aux, x

    def _ssm_forward(self, params: Params, x, positions, impl):
        """The Mamba2 stack; in the hybrid, after every ``attn_every``
        layers the shared attention layer on ``concat(h, emb) @
        shared_in``, whose output (its own residual taken on that input)
        is added to h.  ``remat`` applies to the pure-SSM stack only, as
        in the JAX package."""
        cfg, uk = self.cfg, self.use_kernel
        emb = x

        def layer(lp, h):
            return h + mamba2.mamba2_block(lp, cfg, h, use_kernel=uk)[0]
        remat = cfg.remat and not self._hybrid
        for i, lp in enumerate(self._layers(params)):
            x = _remat(layer, x, lp) if remat else layer(lp, x)
            if self._hybrid and (i + 1) % cfg.attn_every == 0:
                zin = torch.cat([x, emb], dim=-1) @ params["shared_in"]
                y, _ = _layer_fwd(subparams(params, "shared_attn"), cfg, zin,
                                  positions, window=cfg.attention_window,
                                  impl=impl, use_kernel=uk)
                x = x + y
        return x

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
        """Zero decode state on the params' device: KV caches (L, B,
        S_cache, Hk, hd); for the SSM families a ``MambaState`` stacked
        on L, plus in the hybrid one KV cache a group of ``attn_every``
        layers."""
        cfg, dev = self.cfg, params["embed"].device
        if cfg.family not in ("ssm", "hybrid"):
            return {"kv": attn.init_kv_cache(cfg, cfg.n_layers, batch,
                                             seq_len, dtype, dev)}
        one = mamba2.init_mamba_state(cfg, batch, dtype, dev)
        st = {"mamba": mamba2.MambaState(
            ssm=torch.zeros((cfg.n_layers,) + one.ssm.shape, dtype=dtype,
                            device=dev),
            conv=torch.zeros((cfg.n_layers,) + one.conv.shape, dtype=dtype,
                             device=dev))}
        if self._hybrid:
            st["kv"] = attn.init_kv_cache(cfg, cfg.n_layers // cfg.attn_every,
                                          batch, seq_len, dtype, dev)
        return st

    # ---------------------------------------------------------- decode step
    def decode_step(self, params: Params, state, token: torch.Tensor, pos):
        """token: (B, 1) integers; pos: the token's position (an int) ->
        (logits (B,1,V) fp32, state).  The KV caches are written in place
        and the state returned holds the same tensors; a Mamba state is
        returned anew, as the JAX package computes it (float32 from the
        first step on, whatever the dtype it was made in)."""
        cfg = self.cfg
        x = params["embed"][token.long()]
        if cfg.family in ("ssm", "hybrid"):
            x, state = self._ssm_decode(params, state, x, pos)
        else:
            kv = state["kv"]
            for i, lp in enumerate(self._layers(params)):
                x, _, _ = _layer_decode(lp, cfg, x, kv["k"][i], kv["v"][i],
                                        pos, window=cfg.attention_window,
                                        use_kernel=self.use_kernel)
        h = rmsnorm(subparams(params, "ln_f"), x, cfg.norm_eps,
                    use_kernel=self.use_kernel)
        return self._unembed(params, h), state

    def _ssm_decode(self, params: Params, state, x, pos):
        cfg, uk = self.cfg, self.use_kernel
        mst = state["mamba"]
        emb = x
        ssm, conv = [], []
        for i, lp in enumerate(self._layers(params)):
            y, st = mamba2.mamba2_block(
                lp, cfg, x, mamba2.MambaState(mst.ssm[i], mst.conv[i]),
                decode=True, use_kernel=uk)
            x = x + y
            ssm.append(st.ssm)
            conv.append(st.conv)
            if self._hybrid and (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                zin = torch.cat([x, emb], dim=-1) @ params["shared_in"]
                y, _, _ = _layer_decode(
                    subparams(params, "shared_attn"), cfg, zin,
                    state["kv"]["k"][g], state["kv"]["v"][g], pos,
                    window=cfg.attention_window, use_kernel=uk)
                x = x + y
        state = dict(state)
        state["mamba"] = mamba2.MambaState(torch.stack(ssm),
                                           torch.stack(conv))
        return x, state

    # ------------------------------------------------------------ input specs
    def input_specs(self, shape: ShapeConfig, dtype=torch.bfloat16):
        """Meta-device tensors of every model input's shape and dtype, as
        the JAX package's ``ShapeDtypeStruct`` stand-ins (``dtype`` is
        the float dtype of the audio / VLM inputs, which the families
        ported have none of)."""
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
        """Text tokens of a sequence of ``s``: all of them in the families
        ported (the audio and VLM families' prefixes come with 16e)."""
        return s
