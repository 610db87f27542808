"""Fleet workloads: a model family, its data schema and its client builder.

A ``FleetWorkload`` bundles what the fleet engines need to run a model
family end to end:

  * the **model** (init / loss / grad_features / accuracy — the FL
    interface of ``repro_torch.models.small``), delegated so a workload
    can be passed anywhere a model is expected (``run_fleet``);
  * a declared **data schema**: named per-sample array specs (shape
    without the leading sample axis + dtype) that ``validate_clients``
    checks client data against;
  * a **client builder** (``make_clients``) producing the federated
    dataset at any scale from the port's own data generators, which give
    the JAX package's bytes.

Registry, sized for small fleets as in the JAX package:

  * ``mlp``    — LogisticRegression on Synthetic(0.5, 0.5) flat features
                 (convex; input-space distances).
  * ``cnn``    — ``SmallCNN`` on 14x14 pseudo-MNIST images
                 (last-layer-gradient features).
  * ``charlm`` — ``CharLSTM`` on the Shakespeare-style char-LM task.
  * ``xlstm``  — ``CharXLSTM`` (one exponential-gated mLSTM block of
                 ``repro_torch.models.xlstm``; its norm is the CUDA
                 RMSNorm kernel on the card) on the same char-LM data.
  * ``translm`` — ``CharTransformer`` (one pre-norm decoder block of
                 ``repro_torch.models.attention``; its tri-state
                 ``use_kernel`` routes attention through the CUDA
                 flash-attention kernel and its norms through the CUDA
                 RMSNorm kernel) on the same char-LM data.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.data import (mnist_like_dataset, shakespeare_like_dataset,
                              synthetic_dataset)
from repro_torch.data.charlm import VOCAB
from repro_torch.device import DeviceLike
from repro_torch.kernels.ops import resolve_use_kernel
from repro_torch.models.attention import init_attention, multihead_attention
from repro_torch.models.layers import (dense_init, init_mlp, init_rmsnorm,
                                       mlp, rmsnorm)
from repro_torch.models.small import (CharLSTM, FLModule, LogisticRegression,
                                      SmallCNN, token_accuracy)
from repro_torch.models.xlstm import init_mlstm, mlstm_block

ClientData = Dict[str, np.ndarray]


def client_num_samples(data: Mapping[str, Any]) -> int:
    """Leading-axis length of a client's data (all fields share it)."""
    if not data:
        raise ValueError("client data has no array fields")
    return int(np.shape(data[sorted(data)[0]])[0])


def client_sizes(clients_data: Sequence[Mapping[str, Any]]) -> List[int]:
    """Per-client sample counts."""
    return [client_num_samples(d) for d in clients_data]


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """One named field of a workload's per-sample schema."""
    shape: Tuple[int, ...]        # per-sample shape (no leading sample axis)
    dtype: str                    # numpy dtype name, e.g. "float32"


@dataclasses.dataclass(frozen=True)
class FleetWorkload:
    """A model family + data schema + dataset builder, runnable by the
    fleet engines.

    Delegates the FL interface to ``model``, so a ``FleetWorkload`` can
    be passed wherever a model is expected.  ``make_clients(n_clients,
    seed, **overrides)`` builds the federated dataset; ``schema``
    declares what that data looks like and ``validate_clients`` enforces
    it.
    """
    name: str
    model: Any
    schema: Mapping[str, ArraySpec]
    make_clients: Callable[..., List[ClientData]]
    description: str = ""

    # -- FL model delegation ---------------------------------------------
    def init(self, generator, device: DeviceLike = None):
        return self.model.init(generator, device)

    def loss(self, params, batch):
        return self.model.loss(params, batch)

    def accuracy(self, params, batch):
        return self.model.accuracy(params, batch)

    def grad_features(self, params, batch):
        return self.model.grad_features(params, batch)

    @property
    def feature_space(self) -> str:
        return self.model.feature_space

    @property
    def reference_layouts(self) -> Dict[str, Tuple[int, ...]]:
        return getattr(self.model, "reference_layouts", {})

    # -- schema ----------------------------------------------------------
    def validate_clients(self, clients_data: Sequence[Any]) -> None:
        """Check every client against the declared schema: exact
        top-level field names, per-sample shapes, dtypes, and one shared
        sample count across fields.  Raises ``ValueError`` on the first
        mismatch."""
        want = set(self.schema)
        for i, data in enumerate(clients_data):
            if not isinstance(data, Mapping):
                raise ValueError(
                    f"{self.name}: client {i} data must be a mapping of "
                    f"named fields, got {type(data).__name__}")
            got = set(data) - {"weights"}
            if got != want:
                raise ValueError(
                    f"{self.name}: client {i} fields {sorted(got)} != "
                    f"schema fields {sorted(want)}")
            m = client_num_samples(data)
            for kk, spec in self.schema.items():
                v = np.asarray(data[kk])
                if v.shape != (m,) + tuple(spec.shape):
                    raise ValueError(
                        f"{self.name}: client {i} field {kk!r} shape "
                        f"{v.shape} != (m={m},)+{tuple(spec.shape)}")
                if v.dtype != np.dtype(spec.dtype):
                    raise ValueError(
                        f"{self.name}: client {i} field {kk!r} dtype "
                        f"{v.dtype} != {spec.dtype}")


def _tree(group: nn.Module) -> Dict[str, torch.Tensor]:
    """A level of the JAX parameter tree as a dict (the values of the
    params the call was given)."""
    return {name: getattr(group, name) for name in group._parameters}


def _group(**shapes) -> nn.Module:
    """One level of the JAX parameter tree: a module of named placeholder
    leaves."""
    group = nn.Module()
    for name, shape in shapes.items():
        setattr(group, name,
                nn.Parameter(torch.zeros(shape), requires_grad=False))
    return group


# ---------------------------------------------------------------------------
# xLSTM char-LM: one exponential-gated mLSTM block + char head
# ---------------------------------------------------------------------------

class CharXLSTM(FLModule):
    """Char-LM of one mLSTM block of ``repro_torch.models.xlstm`` and a
    char head; the JAX package's ``CharXLSTM``, with its parameter tree's
    paths as keys (``embed``, ``mlstm.norm.scale``, ``mlstm.wq``, ...,
    ``mlstm.bf``, ``w_out``, ``b_out``).

    ``use_kernel`` is the tri-state of the block's RMSNorm
    (``repro_torch.kernels.ops.rmsnorm``), resolved by the tokens'
    device: ``None`` runs the CUDA kernel on the card and the plain
    version on the CPU, ``False`` the plain version on the card (the A/B),
    ``True`` on CPU tokens raises."""

    def __init__(self, vocab: int = 64, d_model: int = 32, n_heads: int = 2,
                 use_kernel: Optional[bool] = None):
        super().__init__()
        self.vocab, self.use_kernel = vocab, use_kernel
        self.cfg = ModelConfig(arch_id="char_xlstm", d_model=d_model,
                               n_heads=n_heads, n_kv_heads=n_heads)
        d, h = d_model, n_heads
        self.embed = self._param(vocab, d)
        self.mlstm = _group(wq=(d, d), wk=(d, d), wv=(d, d), wi=(d, h),
                            wf=(d, h), bf=(h,), bi=(h,), wo_gate=(d, d),
                            w_out=(d, d))
        self.mlstm.norm = _group(scale=(d,))
        self.w_out = self._param(d, vocab)
        self.b_out = self._param(vocab)

    def _init_cpu(self, generator):
        d = self.cfg.d_model
        params = {"embed": torch.randn((self.vocab, d),
                                       generator=generator) * 0.1}
        block = init_mlstm(generator, self.cfg)
        params["mlstm.norm.scale"] = block.pop("norm")["scale"]
        params.update({f"mlstm.{k}": v for k, v in block.items()})
        params["w_out"] = dense_init(generator, d, self.vocab)
        params["b_out"] = torch.zeros((self.vocab,))
        return params

    def forward(self, tokens):
        x = self.embed[tokens.long()]                   # (B, S, d)
        block = dict(_tree(self.mlstm), norm=_tree(self.mlstm.norm))
        x, _ = mlstm_block(block, self.cfg, x, use_kernel=self.use_kernel)
        return x @ self.w_out + self.b_out

    def accuracy(self, params, batch):
        return token_accuracy(self.logits(params, batch["x"]), batch["y"])


# ---------------------------------------------------------------------------
# transformer char-LM: one pre-norm decoder block over the flash kernel
# ---------------------------------------------------------------------------

class CharTransformer(FLModule):
    """Char-LM of one pre-norm decoder block: causal multi-head
    self-attention with RoPE, then a SwiGLU MLP, each around RMSNorm, and
    a char head; the JAX package's ``CharTransformer``, with its
    parameter tree's paths as keys (``attn.wq``, ``mlp.w_gate``,
    ``norm_out.scale``, ...).

    ``use_kernel`` is the JAX package's tri-state, resolved by the
    tokens' device: true runs attention through
    ``repro_torch.kernels.ops.flash_attention`` (the CUDA kernel, impl
    ``"kernel"``), false through the naive attention; ``None`` picks the
    kernel on the card and the naive attention on the CPU; ``True`` on
    CPU tokens raises.  The same switch picks the three RMSNorms' CUDA
    kernel or plain version (``ops.rmsnorm``), so ``use_kernel=False``
    is the all-plain model."""

    def __init__(self, vocab: int = 64, d_model: int = 32, n_heads: int = 2,
                 d_ff: int = 64, use_kernel: Optional[bool] = None):
        super().__init__()
        self.vocab, self.d_ff, self.use_kernel = vocab, d_ff, use_kernel
        self.cfg = ModelConfig(arch_id="char_translm", d_model=d_model,
                               n_heads=n_heads, n_kv_heads=n_heads)
        d, hd = d_model, self.cfg.d_head
        self.embed = self._param(vocab, d)
        self.norm_attn = _group(scale=(d,))
        self.attn = _group(wq=(d, n_heads * hd), wk=(d, n_heads * hd),
                           wv=(d, n_heads * hd), wo=(n_heads * hd, d))
        self.norm_mlp = _group(scale=(d,))
        self.mlp = _group(w_gate=(d, d_ff), w_up=(d, d_ff),
                          w_down=(d_ff, d))
        self.norm_out = _group(scale=(d,))
        self.w_out = self._param(d, vocab)
        self.b_out = self._param(vocab)

    def _init_cpu(self, generator):
        d = self.cfg.d_model
        params = {"embed": torch.randn((self.vocab, d),
                                       generator=generator) * 0.1}
        for group, leaves in (
                ("norm_attn", init_rmsnorm(d)),
                ("attn", init_attention(generator, self.cfg)),
                ("norm_mlp", init_rmsnorm(d)),
                ("mlp", init_mlp(generator, self.cfg, d_ff=self.d_ff)),
                ("norm_out", init_rmsnorm(d))):
            params.update({f"{group}.{k}": v for k, v in leaves.items()})
        params["w_out"] = dense_init(generator, d, self.vocab)
        params["b_out"] = torch.zeros((self.vocab,))
        return params

    def impl(self, tokens: torch.Tensor) -> str:
        """The attention implementation for ``tokens``' device."""
        return ("kernel" if resolve_use_kernel(self.use_kernel, tokens.device)
                else "naive")

    def forward(self, tokens):
        cfg = self.cfg
        x = self.embed[tokens.long()]                   # (B, S, d)
        uk = self.use_kernel
        x = x + multihead_attention(
            _tree(self.attn), cfg,
            rmsnorm(_tree(self.norm_attn), x, use_kernel=uk),
            causal=True, impl=self.impl(tokens))
        x = x + mlp(_tree(self.mlp),
                    rmsnorm(_tree(self.norm_mlp), x, use_kernel=uk),
                    act=cfg.act)
        x = rmsnorm(_tree(self.norm_out), x, use_kernel=uk)
        return x @ self.w_out + self.b_out

    def accuracy(self, params, batch):
        return token_accuracy(self.logits(params, batch["x"]), batch["y"])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _mlp_workload() -> FleetWorkload:
    n_features, n_classes = 60, 10

    def make_clients(n_clients: int = 64, seed: int = 0,
                     mean_samples: float = 48.0, std_samples: float = 32.0
                     ) -> List[ClientData]:
        return synthetic_dataset(0.5, 0.5, n_clients=n_clients,
                                 n_features=n_features, n_classes=n_classes,
                                 mean_samples=mean_samples,
                                 std_samples=std_samples, seed=seed)

    return FleetWorkload(
        name="mlp", model=LogisticRegression(n_features, n_classes),
        schema={"x": ArraySpec((n_features,), "float32"),
                "y": ArraySpec((), "int32")},
        make_clients=make_clients,
        description="LogisticRegression on Synthetic(0.5, 0.5) flat "
                    "features (convex; input-space distances)")


def _cnn_workload() -> FleetWorkload:
    # 14x14 pseudo-MNIST: the paper's MNIST task family at a quarter of
    # the pixels, as the JAX package sizes it for small fleets
    size, channels = 14, (8, 16)

    def make_clients(n_clients: int = 64, seed: int = 0,
                     mean_samples: float = 40.0, std_samples: float = 24.0
                     ) -> List[ClientData]:
        return mnist_like_dataset(n_clients=n_clients,
                                  mean_samples=mean_samples,
                                  std_samples=std_samples,
                                  size=size, seed=seed)

    return FleetWorkload(
        name="cnn", model=SmallCNN(image_size=size, channels=channels),
        schema={"x": ArraySpec((size, size), "float32"),
                "y": ArraySpec((), "int32")},
        make_clients=make_clients,
        description="SmallCNN on pseudo-MNIST images "
                    "(last-layer-gradient features)")


_CHARLM_SEQ_LEN = 16


def _charlm_clients(n_clients: int = 64, seed: int = 0,
                    mean_samples: float = 40.0, std_samples: float = 24.0
                    ) -> List[ClientData]:
    return shakespeare_like_dataset(n_clients=n_clients,
                                    mean_samples=mean_samples,
                                    std_samples=std_samples,
                                    seq_len=_CHARLM_SEQ_LEN, seed=seed)


def _charlm_workload() -> FleetWorkload:
    return FleetWorkload(
        name="charlm",
        model=CharLSTM(vocab=VOCAB, d_embed=8, d_hidden=32, n_layers=1),
        schema={"x": ArraySpec((_CHARLM_SEQ_LEN,), "int32"),
                "y": ArraySpec((_CHARLM_SEQ_LEN,), "int32")},
        make_clients=_charlm_clients,
        description="CharLSTM next-character prediction on the "
                    "Shakespeare-style char-LM task")


def _xlstm_workload() -> FleetWorkload:
    return FleetWorkload(
        name="xlstm", model=CharXLSTM(vocab=VOCAB, d_model=32, n_heads=2),
        schema={"x": ArraySpec((_CHARLM_SEQ_LEN,), "int32"),
                "y": ArraySpec((_CHARLM_SEQ_LEN,), "int32")},
        make_clients=_charlm_clients,
        description="one-block exponential-gated mLSTM char-LM (RMSNorm "
                    "kernel on the card) on the same sequence data as "
                    "charlm")


def _translm_workload() -> FleetWorkload:
    return FleetWorkload(
        name="translm",
        model=CharTransformer(vocab=VOCAB, d_model=32, n_heads=2),
        schema={"x": ArraySpec((_CHARLM_SEQ_LEN,), "int32"),
                "y": ArraySpec((_CHARLM_SEQ_LEN,), "int32")},
        make_clients=_charlm_clients,
        description="one-block pre-norm decoder transformer char-LM "
                    "(flash-attention kernel on the card) on the same "
                    "sequence data as charlm")


WORKLOADS: Dict[str, Callable[[], FleetWorkload]] = {
    "mlp": _mlp_workload,
    "cnn": _cnn_workload,
    "charlm": _charlm_workload,
    "xlstm": _xlstm_workload,
    "translm": _translm_workload,
}


def get_workload(name: str) -> FleetWorkload:
    """Materialize a registered workload by name."""
    try:
        return WORKLOADS[name]()
    except KeyError:
        raise ValueError(f"unknown fleet workload {name!r} "
                         f"(expected one of {sorted(WORKLOADS)})") from None
