"""The decoder-LM ``Model`` of the JAX package's ``models/model.py``,
for all seven families: dense, MoE, SSM, hybrid, xLSTM, audio
(encoder-decoder) and VLM.

``Model(cfg)`` exposes:

  init(generator, device)                -> params (flat dict)
  forward(params, batch, impl)           -> (logits, aux, last_hidden)
  loss(params, batch)                    -> (scalar, metrics)  [weighted CE]
  init_decode_state(params, batch, seq_len) -> KV caches / recurrent states
  decode_step(params, state, token, pos) -> (logits, state)
  input_specs(shape)                     -> meta-device stand-ins

Parameters are a flat dict whose keys are the JAX tree paths
(``embed``, ``ln_f.scale``, ``w_unembed``, ``layers.attn.wq``,
``layers.moe.router``, ``layers.w_in``, ``shared_attn.attn.wq``,
``blocks.3.r``, ``dec_layers.1.xattn.wq``, ...); the dense, MoE, VLM
and SSM layers are stacked on a leading L axis, as the JAX package
stacks them for ``lax.scan``, and the xLSTM blocks and the audio
model's encoder and decoder layers are lists there, each item under its
index here, so ``repro_torch.convert.params_from_jax`` carries every
leaf over unchanged.  The forward pass is a Python loop over the
layers, each under ``torch.utils.checkpoint`` when ``cfg.remat`` is set
(the JAX package's ``jax.checkpoint``; for the SSM families only on the
pure-SSM stack, as there).

The ``moe`` family runs ``models/moe.py``'s FFN in each layer and
returns the sum of the layers' load-balance losses as ``aux``.  The
``ssm`` family is a stack of Mamba2 blocks (``models/mamba2.py``); the
``hybrid`` family (zamba2) adds one shared attention layer, applied
after every ``attn_every`` Mamba2 layers to ``concat(h, emb) @
shared_in`` and added to h.  The ``xlstm`` family runs
``cfg.xlstm_pattern``'s mLSTM (``m``) and sLSTM (``s``) blocks, each
adding its own residual.  The ``vlm`` family is the dense stack over
``batch["patch_embeddings"]`` (B, P, d) put before the tokens, the
prefix dropped before the unembedding; it decodes as the dense model,
so the served tokens never see the patches (in the JAX package
neither).  The ``audio`` family (whisper) is an encoder of
``cfg.enc_layers`` non-causal GELU layers over
``batch["encoder_embeddings"]`` (the stub frontend's frames) and a
decoder whose layers add cross-attention over the encoder's output;
both take sinusoidal positions and no RoPE.  Its decode state holds the
encoder's K/V of each decoder layer, computed once.

Every RMSNorm goes through kernel 8 (``ops.rmsnorm``) and, with
``impl="kernel"``, self-attention through kernel 7
(``ops.flash_attention``: causal, or non-causal in the audio encoder);
cross-attention takes the chunked path, as the JAX package's
``"pallas"`` does.  ``use_kernel`` is the kernels' tri-state
(``Model(cfg, use_kernel=False)`` on the card is the plain twin).
``impl=None`` resolves by the activations' device, as
``ops.resolve_use_kernel`` does: ``"kernel"`` on a CUDA device,
``"chunked"`` on the CPU (the JAX package's ``CharTransformer``
resolves to ``"pallas"`` on a TPU alike).

Batch format (integer tokens, -100 = masked label):
  tokens  (B, S)        labels (B, S)
  weights (B,) float32  optional per-example coreset weights (FedCore δ/m)
  encoder_embeddings (B, S_enc, d) float  [audio family stub frontend]
  patch_embeddings   (B, P, d) float      [vlm family stub frontend]
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import resolve_use_kernel
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe, xlstm
from repro_torch.models.layers import (dense_init, embed_init, init_mlp,
                                       init_rmsnorm, init_stacked, mlp,
                                       rmsnorm, sinusoidal_pos, subparams)
from repro_torch.models.small import _weighted_ce

IGNORE = -100
Params = Dict[str, torch.Tensor]

_FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid", "xlstm")


# ---------------------------------------------------------------------------
# transformer layer (dense or moe)
# ---------------------------------------------------------------------------

def _init_layer(generator: torch.Generator, cfg: ModelConfig,
                cross: bool = False) -> Params:
    """A pre-norm layer: ``ln1``, ``attn``, ``ln2`` and the FFN, and with
    ``cross`` the decoder's ``ln_x`` and cross-attention ``xattn``."""
    dev = generator.device
    ffn = (("moe", moe.init_moe(generator, cfg)) if cfg.n_experts > 0
           else ("mlp", init_mlp(generator, cfg)))
    groups = (("ln1", init_rmsnorm(cfg.d_model, dev)),
              ("attn", attn.init_attention(generator, cfg)),
              ("ln2", init_rmsnorm(cfg.d_model, dev)), ffn)
    if cross:
        groups += (("ln_x", init_rmsnorm(cfg.d_model, dev)),
                   ("xattn", attn.init_attention(generator, cfg,
                                                 cross=True)))
    return {f"{g}.{k}": v for g, leaves in groups for k, v in leaves.items()}


def _ffn(p: Params, cfg: ModelConfig, h):
    """The layer's FFN on h: (y, the MoE load-balance loss or None)."""
    if cfg.n_experts > 0:
        return moe.moe_ffn(subparams(p, "moe"), cfg, h)
    return mlp(subparams(p, "mlp"), h, cfg.act), None


def _layer_fwd(p: Params, cfg: ModelConfig, x, positions, *, causal=True,
               window=None, impl, use_kernel, use_rope=True, enc=None,
               enc_positions=None):
    """(x + attention [+ cross-attention over ``enc``] + FFN, the layer's
    aux or None)."""
    h = rmsnorm(subparams(p, "ln1"), x, cfg.norm_eps, use_kernel=use_kernel)
    x = x + attn.multihead_attention(subparams(p, "attn"), cfg, h, positions,
                                     causal=causal, window=window, impl=impl,
                                     use_rope=use_rope, use_kernel=use_kernel)
    if enc is not None:
        h = rmsnorm(subparams(p, "ln_x"), x, cfg.norm_eps,
                    use_kernel=use_kernel)
        x = x + attn.multihead_attention(
            subparams(p, "xattn"), cfg, h, positions, causal=False,
            impl=impl, kv_x=enc, kv_positions=enc_positions, use_rope=False,
            use_kernel=use_kernel)
    h = rmsnorm(subparams(p, "ln2"), x, cfg.norm_eps, use_kernel=use_kernel)
    y, aux = _ffn(p, cfg, h)
    return x + y, aux


def _layer_decode(p: Params, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                  window, use_kernel, use_rope=True, enc_k=None, enc_v=None):
    h = rmsnorm(subparams(p, "ln1"), x, cfg.norm_eps, use_kernel=use_kernel)
    y, cache_k, cache_v = attn.attention_decode(
        subparams(p, "attn"), cfg, h, cache_k, cache_v, pos, window=window,
        use_rope=use_rope)
    x = x + y
    if enc_k is not None:
        h = rmsnorm(subparams(p, "ln_x"), x, cfg.norm_eps,
                    use_kernel=use_kernel)
        x = x + attn.cross_attention_decode(subparams(p, "xattn"), cfg, h,
                                            enc_k, enc_v)
    h = rmsnorm(subparams(p, "ln2"), x, cfg.norm_eps, use_kernel=use_kernel)
    return x + _ffn(p, cfg, h)[0], cache_k, cache_v


def _nested(flat: Params) -> Dict:
    """An xLSTM block's flat leaves as the nested dict its block function
    takes (``norm.scale`` -> ``{"norm": {"scale": ...}}``)."""
    out: Dict = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = out
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = v
    return out


def _flat(prefix: str, tree: Dict) -> Params:
    """The inverse of ``_nested``, under ``prefix``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(f"{prefix}{k}.", v))
        else:
            out[f"{prefix}{k}"] = v
    return out


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
        if cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {cfg.family}")

    @property
    def _hybrid(self) -> bool:
        return self.cfg.family == "hybrid" and bool(self.cfg.attn_every)

    @property
    def _enc_cfg(self) -> ModelConfig:
        """The audio encoder's config: the decoder's with a GELU MLP."""
        return self.cfg.with_(act="gelu")

    def _layers(self, params: Params):
        """Layer i's params (views of the stacked leaves), i = 0 … L−1."""
        keys = [k for k in params if k.startswith("layers.")]
        for i in range(self.cfg.n_layers):
            yield {k[len("layers."):]: params[k][i] for k in keys}

    @staticmethod
    def _listed(params: Params, name: str, n: int):
        """The i-th item of the list ``name`` (``enc_layers``,
        ``dec_layers``, ``blocks``), i = 0 … n−1."""
        for i in range(n):
            yield subparams(params, f"{name}.{i}")

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Params:
        """Draws every leaf on ``generator``'s device (a torch.Generator on
        the card draws yi-9b's 8.8 B parameters there), then puts the
        params on ``device`` (None = the card).  The dense, MoE and VLM
        families stack their layers, the SSM families Mamba2 layers (the
        hybrid adds the unstacked ``shared_attn`` layer and ``shared_in``
        (2d, d)); the audio family lists ``enc_layers`` (GELU),
        ``enc_ln`` and ``dec_layers`` (with cross-attention), the xLSTM
        family ``blocks`` by ``cfg.xlstm_pattern``."""
        cfg = self.cfg
        dev = resolve_device(device)
        params = {"embed": embed_init(generator, cfg.vocab_size,
                                      cfg.d_model),
                  "ln_f.scale": init_rmsnorm(cfg.d_model,
                                             generator.device)["scale"]}
        if not cfg.tie_embeddings:
            params["w_unembed"] = dense_init(generator, cfg.d_model,
                                             cfg.vocab_size, scale=0.02)
        layers = {}
        if cfg.family in ("ssm", "hybrid"):
            layers = init_stacked(generator, cfg.n_layers,
                                  lambda g: mamba2.init_mamba2(g, cfg))
            if self._hybrid:
                params.update({f"shared_attn.{k}": v for k, v in
                               _init_layer(generator, cfg).items()})
                params["shared_in"] = dense_init(generator, 2 * cfg.d_model,
                                                 cfg.d_model)
        elif cfg.family == "audio":
            for i in range(cfg.enc_layers):
                params.update(_flat(f"enc_layers.{i}.", _init_layer(
                    generator, self._enc_cfg)))
            params["enc_ln.scale"] = init_rmsnorm(
                cfg.d_model, generator.device)["scale"]
            for i in range(cfg.n_layers):
                params.update(_flat(f"dec_layers.{i}.", _init_layer(
                    generator, cfg, cross=True)))
        elif cfg.family == "xlstm":
            for i, ch in enumerate(cfg.xlstm_pattern):
                init = xlstm.init_mlstm if ch == "m" else xlstm.init_slstm
                params.update(_flat(f"blocks.{i}.", init(generator, cfg)))
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
        """Returns (logits (B,S,V) fp32, aux scalar, last_hidden (B,S,d)):
        the VLM's over the S text positions, its patch prefix dropped."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = params["embed"][tokens.long()]
        prefix = 0
        if cfg.family == "vlm":
            patches = batch["patch_embeddings"].to(x.dtype)
            prefix = patches.shape[1]
            x = torch.cat([patches, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        impl = self.resolve_impl(impl, x.device)
        uk = self.use_kernel
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in ("ssm", "hybrid"):
            x = self._ssm_forward(params, x, positions, impl)
        elif cfg.family == "audio":
            enc = batch["encoder_embeddings"].to(x.dtype)
            enc = self._encode(params, enc + sinusoidal_pos(
                enc.shape[1], cfg.d_model, x.device), impl)
            enc_pos = torch.arange(enc.shape[1], device=x.device)
            x = x + sinusoidal_pos(x.shape[1], cfg.d_model, x.device)
            for lp in self._listed(params, "dec_layers", cfg.n_layers):
                x, _ = _layer_fwd(lp, cfg, x, positions,
                                  window=cfg.attention_window, impl=impl,
                                  use_kernel=uk, use_rope=False, enc=enc,
                                  enc_positions=enc_pos)
        elif cfg.family == "xlstm":
            for bp, ch in zip(self._listed(params, "blocks",
                                           len(cfg.xlstm_pattern)),
                              cfg.xlstm_pattern):
                blk = xlstm.mlstm_block if ch == "m" else xlstm.slstm_block
                x, _ = blk(_nested(bp), cfg, x, use_kernel=uk)
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
        if prefix:
            x = x[:, prefix:]
        return self._unembed(params, x), aux, x

    def _encode(self, params: Params, enc: torch.Tensor, impl: str):
        """The audio encoder over frame embeddings (B, S_enc, d) that
        hold their sinusoidal positions: the non-causal GELU layers
        without RoPE, then ``enc_ln``."""
        cfg, uk = self.cfg, self.use_kernel
        enc_pos = torch.arange(enc.shape[1], device=enc.device)
        for lp in self._listed(params, "enc_layers", cfg.enc_layers):
            enc, _ = _layer_fwd(lp, self._enc_cfg, enc, enc_pos,
                                causal=False, impl=impl, use_kernel=uk,
                                use_rope=False)
        return rmsnorm(subparams(params, "enc_ln"), enc, cfg.norm_eps,
                       use_kernel=uk)

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
                          dtype=torch.bfloat16, enc_embeddings=None):
        """Decode state on the params' device: KV caches (L, B, S_cache,
        Hk, hd) for the attention families (the VLM's the dense ones); for
        the SSM families a ``MambaState`` stacked on L, plus in the hybrid
        one KV cache a group of ``attn_every`` layers; for the xLSTM
        family each block's state.  The audio family adds the encoder's
        K and V of each decoder layer (L, B, S_enc, Hk, hd): the encoder
        runs once here, over ``enc_embeddings`` (B, S_enc, d) or, without
        them, over zeros of min(max(1, int(seq_len·enc_seq_frac)), 4096)
        frames (the JAX package's stand-in), in ``dtype``; through
        kernel 7 on the card, as the forward's encoder."""
        cfg, dev = self.cfg, params["embed"].device
        if cfg.family == "xlstm":
            return {"blocks": [
                (xlstm.init_mlstm_state if ch == "m"
                 else xlstm.init_slstm_state)(cfg, batch, dtype, dev)
                for ch in cfg.xlstm_pattern]}
        if cfg.family not in ("ssm", "hybrid"):
            st = {"kv": attn.init_kv_cache(cfg, cfg.n_layers, batch,
                                           seq_len, dtype, dev)}
            if cfg.family == "audio":
                st.update(self._encoder_kv(params, batch, seq_len, dtype,
                                           enc_embeddings))
            return st
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

    def _encoder_kv(self, params: Params, batch: int, seq_len: int, dtype,
                    enc_embeddings):
        """{"enc_k", "enc_v"}: each decoder layer's cross-attention K and
        V of the encoder's output, stacked on L."""
        cfg, dev = self.cfg, params["embed"].device
        if enc_embeddings is None:
            s_enc = max(1, int(seq_len * cfg.enc_seq_frac))
            enc = torch.zeros((batch, min(s_enc, 4096), cfg.d_model),
                              dtype=dtype, device=dev)
        else:
            enc = enc_embeddings
        # the frames keep their dtype, as in the JAX package: fp32 frames
        # plus the positions rounded to ``dtype`` are fp32, the zero
        # encoder is in ``dtype``
        enc = enc + sinusoidal_pos(enc.shape[1], cfg.d_model, dev).to(dtype)
        with torch.no_grad():
            h = self._encode(params, enc, self.resolve_impl(None, dev))
            hk, hd = cfg.n_kv_heads, cfg.d_head
            eks, evs = [], []
            for lp in self._listed(params, "dec_layers", cfg.n_layers):
                eks.append((h @ lp["xattn.wk"].to(h.dtype)).reshape(
                    batch, -1, hk, hd))
                evs.append((h @ lp["xattn.wv"].to(h.dtype)).reshape(
                    batch, -1, hk, hd))
        return {"enc_k": torch.stack(eks), "enc_v": torch.stack(evs)}

    # ---------------------------------------------------------- decode step
    def decode_step(self, params: Params, state, token: torch.Tensor, pos):
        """token: (B, 1) integers; pos: the token's position (an int) ->
        (logits (B,1,V) fp32, state).  The KV caches are written in place
        and the state returned holds the same tensors; a Mamba state and
        the xLSTM blocks' states are returned anew, as the JAX package
        computes them (float32 from the first step on, whatever the dtype
        they were made in)."""
        cfg, uk = self.cfg, self.use_kernel
        x = params["embed"][token.long()]
        if cfg.family in ("ssm", "hybrid"):
            x, state = self._ssm_decode(params, state, x, pos)
        elif cfg.family == "xlstm":
            sts = []
            for bp, ch, st in zip(self._listed(params, "blocks",
                                               len(cfg.xlstm_pattern)),
                                  cfg.xlstm_pattern, state["blocks"]):
                blk = xlstm.mlstm_block if ch == "m" else xlstm.slstm_block
                x, st = blk(_nested(bp), cfg, x, st, decode=True,
                            use_kernel=uk)
                sts.append(st)
            state = {"blocks": sts}
        elif cfg.family == "audio":
            kv = state["kv"]
            x = x + _sin_pos_at(pos, cfg.d_model, x.device).to(x.dtype)
            for i, lp in enumerate(self._listed(params, "dec_layers",
                                                cfg.n_layers)):
                x, _, _ = _layer_decode(
                    lp, cfg, x, kv["k"][i], kv["v"][i], pos,
                    window=cfg.attention_window, use_kernel=uk,
                    use_rope=False, enc_k=state["enc_k"][i],
                    enc_v=state["enc_v"][i])
        else:
            kv = state["kv"]
            for i, lp in enumerate(self._layers(params)):
                x, _, _ = _layer_decode(lp, cfg, x, kv["k"][i], kv["v"][i],
                                        pos, window=cfg.attention_window,
                                        use_kernel=uk)
        h = rmsnorm(subparams(params, "ln_f"), x, cfg.norm_eps,
                    use_kernel=uk)
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
        the float dtype of the audio model's ``encoder_embeddings`` and
        the VLM's ``patch_embeddings``)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def spec(shp, dt):
            return torch.empty(shp, dtype=dt, device="meta")

        if shape.kind in ("train", "prefill"):
            text = self._text_len(s)
            specs = {"tokens": spec((b, text), torch.int32),
                     "labels": spec((b, text), torch.int32)}
            if shape.kind == "train":
                specs["weights"] = spec((b,), torch.float32)
            if cfg.family == "audio":
                specs["encoder_embeddings"] = spec((b, s - text,
                                                    cfg.d_model), dtype)
            if cfg.family == "vlm":
                specs["patch_embeddings"] = spec(
                    (b, self._n_patches(s), cfg.d_model), dtype)
            return specs
        # decode: one token + position
        return {"token": spec((b, 1), torch.int32),
                "pos": spec((), torch.int32)}

    def _text_len(self, s: int) -> int:
        """Text tokens of a sequence of ``s`` positions: the audio model
        gives ``int(s·enc_seq_frac)`` of them to the encoder's frames, the
        VLM ``_n_patches(s)`` to its patches."""
        cfg = self.cfg
        if cfg.family == "audio":
            return s - int(s * cfg.enc_seq_frac)
        if cfg.family == "vlm":
            return s - self._n_patches(s)
        return s

    def _n_patches(self, s: int) -> int:
        return min(max(self.cfg.n_patches, 1), s // 4)


def _sin_pos_at(pos: int, d: int, device=None) -> torch.Tensor:
    """(d,) float32 sinusoidal embedding of one position, computed in
    float32 as the JAX package's decode computes it (its forward's
    ``sinusoidal_pos`` takes the angles in float64, so the two differ in
    the last bits)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    ang = float(pos) / torch.pow(10000.0, 2 * i / d)
    out = torch.zeros((d,), dtype=torch.float32, device=device)
    out[0::2] = torch.sin(ang)
    out[1::2] = torch.cos(ang)
    return out
