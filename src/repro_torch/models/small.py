"""The paper's own evaluation models (§6.1) in PyTorch: logistic
regression for Synthetic(α,β), a small CNN for (pseudo-)MNIST, and an LSTM
char-LM for the Shakespeare-style benchmark.

Each model is an ``nn.Module`` whose parameter names are the JAX
package's param-dict keys (``conv1``, ``b1``, ``w_out``, ``lstm0.wx``,
...), and exposes the same FL interface with the parameters passed
explicitly, run through ``torch.func.functional_call``:

  init(generator, device) -> params (dict[str, Tensor])
  logits(params, x) -> (B, ..., C)
  loss(params, batch) -> (scalar, metrics)       [supports batch["weights"]]
  accuracy(params, batch) -> scalar
  grad_features(params, batch) -> (B, F)         [FedCore §4.3 proxies]
  feature_space: "input" (convex d̃) or "last_layer_grad" (DNN d̂)

Layouts follow the JAX package at the public functions: images are
(B, H, W) or (B, H, W, 1); SmallCNN's convolution weights are stored
OIHW (``repro_torch.convert`` maps the reference's HWIO), and its
activations are flattened in H, W, C order so ``w_out`` is the
reference's matrix unchanged.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import dense_init

IGNORE = -100
Params = Dict[str, torch.Tensor]


def _weighted_ce(logits, labels, weights=None):
    """logits (B, ..., C); labels (B, ...); weights (B,) or None."""
    logp = F.log_softmax(logits.float(), dim=-1)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = nll * valid
    if nll.ndim > 1:
        axes = tuple(range(1, nll.ndim))
        per_example = (torch.sum(nll, dim=axes)
                       / torch.clamp_min(torch.sum(valid, dim=axes), 1))
    else:
        per_example = nll / torch.clamp_min(valid.to(torch.int64), 1)
    if weights is None:
        weights = torch.ones(per_example.shape[0], dtype=torch.float32,
                             device=per_example.device)
    total = (torch.sum(per_example * weights)
             / torch.clamp_min(torch.sum(weights), 1e-9))
    return total, per_example


def token_accuracy(logits, labels):
    """Share of the valid (non-``IGNORE``) positions predicted right."""
    valid = labels != IGNORE
    correct = (torch.argmax(logits, -1) == labels) & valid
    return torch.sum(correct) / torch.clamp_min(torch.sum(valid), 1)


def _last_layer_grad_feature(logits, labels, w_out):
    """FedCore §4.3 DNN proxy: dL/dz = (softmax(logits) - onehot(y)) W_outᵀ.

    logits (B, ..., C); w_out (F, C).  Token/position axes are mean-pooled
    so each *sample* yields one feature vector."""
    p = torch.softmax(logits.float(), dim=-1)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    onehot = F.one_hot(safe, logits.shape[-1]).float()
    dlogits = (p - onehot) * valid[..., None]
    feat = dlogits @ w_out.T.float()                 # (B, ..., F)
    if feat.ndim > 2:
        axes = tuple(range(1, feat.ndim - 1))
        feat = (torch.sum(feat, dim=axes)
                / torch.clamp_min(torch.sum(valid, dim=axes), 1)[..., None])
    return feat


class FLModule(nn.Module):
    """The FL interface over ``forward`` (= logits) and explicit params.

    The module's own parameters only fix names and shapes; every call
    runs on the params it is given.  ``reference_layouts`` maps a leaf
    stored in another layout than the JAX package's to the permutation
    of its axes that gives the JAX layout (the fault axis draws its
    per-leaf noise in that layout)."""
    feature_space = "last_layer_grad"
    reference_layouts: Dict[str, Tuple[int, ...]] = {}

    def _param(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape), requires_grad=False)

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Params:
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in self._init_cpu(generator).items()}

    def _init_cpu(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self, params, (x,))

    def loss(self, params: Params, batch):
        logits = self.logits(params, batch["x"])
        total, per_example = _weighted_ce(logits, batch["y"],
                                          batch.get("weights"))
        return total, {"loss": total, "per_example_loss": per_example}

    def accuracy(self, params: Params, batch) -> torch.Tensor:
        logits = self.logits(params, batch["x"])
        return torch.mean((torch.argmax(logits, -1) == batch["y"]).float())

    def grad_features(self, params: Params, batch) -> torch.Tensor:
        logits = self.logits(params, batch["x"])
        return _last_layer_grad_feature(logits, batch["y"], params["w_out"])


# ---------------------------------------------------------------------------
# Logistic regression (Synthetic benchmark; convex -> input-space distances)
# ---------------------------------------------------------------------------

class LogisticRegression(FLModule):
    feature_space = "input"

    def __init__(self, n_features: int = 60, n_classes: int = 10):
        super().__init__()
        self.n_features, self.n_classes = n_features, n_classes
        self.w = self._param(n_features, n_classes)
        self.b = self._param(n_classes)

    def _init_cpu(self, generator):
        return {"w": torch.zeros((self.n_features, self.n_classes)),
                "b": torch.zeros((self.n_classes,))}

    def forward(self, x):
        return x @ self.w + self.b

    def grad_features(self, params, batch):
        # convex model: paper uses input-space Euclidean distances (d̃)
        return batch["x"]


# ---------------------------------------------------------------------------
# Small CNN (MNIST benchmark)
# ---------------------------------------------------------------------------

class SmallCNN(FLModule):
    """Three-layer CNN: 2 conv (5x5) + 1 dense head, as in the paper."""
    reference_layouts = {"conv1": (2, 3, 1, 0),      # OIHW -> HWIO
                         "conv2": (2, 3, 1, 0)}

    def __init__(self, image_size: int = 28,
                 channels: Tuple[int, int] = (16, 32), n_classes: int = 10):
        super().__init__()
        self.image_size, self.channels = image_size, tuple(channels)
        self.n_classes = n_classes
        c1, c2 = self.channels
        s = image_size // 4  # two 2x2 pools
        self.conv1 = self._param(c1, 1, 5, 5)     # OIHW
        self.b1 = self._param(c1)
        self.conv2 = self._param(c2, c1, 5, 5)
        self.b2 = self._param(c2)
        self.w_out = self._param(s * s * c2, n_classes)
        self.b_out = self._param(n_classes)

    def _init_cpu(self, generator):
        c1, c2 = self.channels
        s = self.image_size // 4
        return {
            "conv1": torch.randn((c1, 1, 5, 5), generator=generator) * 0.1,
            "b1": torch.zeros((c1,)),
            "conv2": torch.randn((c2, c1, 5, 5), generator=generator) * 0.1,
            "b2": torch.zeros((c2,)),
            "w_out": dense_init(generator, s * s * c2, self.n_classes),
            "b_out": torch.zeros((self.n_classes,)),
        }

    def features(self, x):
        """x: (B, H, W) or (B, H, W, 1) -> (B, F) pre-head features."""
        x = x[:, None] if x.ndim == 3 else x.permute(0, 3, 1, 2)
        for w, b in ((self.conv1, self.b1), (self.conv2, self.b2)):
            # 5x5 "SAME" at stride 1 = 2 rows/cols of zeros on each side
            x = F.conv2d(x, w, padding=2) + b[None, :, None, None]
            x = torch.relu(x)
            x = F.max_pool2d(x, 2, 2)                 # 2x2 "VALID"
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # H, W, C

    def forward(self, x):
        return self.features(x) @ self.w_out + self.b_out


# ---------------------------------------------------------------------------
# LSTM char-LM (Shakespeare benchmark)
# ---------------------------------------------------------------------------

class _LSTMLayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int):
        super().__init__()
        self.wx = nn.Parameter(torch.zeros(d_in, 4 * d_hidden),
                               requires_grad=False)
        self.wh = nn.Parameter(torch.zeros(d_hidden, 4 * d_hidden),
                               requires_grad=False)
        self.b = nn.Parameter(torch.zeros(4 * d_hidden), requires_grad=False)

    def forward(self, x):
        """x: (B, S, D) -> (B, S, H), one explicit step per position (the
        reference's ``lax.scan``), gates i, f, g, o."""
        bsz, hid = x.shape[0], self.wh.shape[0]
        h = x.new_zeros((bsz, hid))
        c = x.new_zeros((bsz, hid))
        hs = []
        for t in range(x.shape[1]):
            gates = x[:, t] @ self.wx + h @ self.wh + self.b
            i, f, g, o = torch.split(gates, hid, dim=-1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1)


class CharLSTM(FLModule):

    def __init__(self, vocab: int = 80, d_embed: int = 8,
                 d_hidden: int = 128, n_layers: int = 2):
        super().__init__()
        self.vocab, self.d_embed = vocab, d_embed
        self.d_hidden, self.n_layers = d_hidden, n_layers
        self.embed = self._param(vocab, d_embed)
        self.w_out = self._param(d_hidden, vocab)
        self.b_out = self._param(vocab)
        d_in = d_embed
        for i in range(n_layers):
            setattr(self, f"lstm{i}", _LSTMLayer(d_in, d_hidden))
            d_in = d_hidden

    def _init_cpu(self, generator):
        params = {
            "embed": torch.randn((self.vocab, self.d_embed),
                                 generator=generator) * 0.1,
            "w_out": dense_init(generator, self.d_hidden, self.vocab),
            "b_out": torch.zeros((self.vocab,)),
        }
        d_in = self.d_embed
        for i in range(self.n_layers):
            params[f"lstm{i}.wx"] = dense_init(generator, d_in,
                                               4 * self.d_hidden)
            params[f"lstm{i}.wh"] = dense_init(generator, self.d_hidden,
                                               4 * self.d_hidden)
            params[f"lstm{i}.b"] = torch.zeros((4 * self.d_hidden,))
            d_in = self.d_hidden
        return params

    def hidden(self, tokens):
        x = self.embed[tokens.long()]
        for i in range(self.n_layers):
            x = getattr(self, f"lstm{i}")(x)
        return x

    def forward(self, tokens):
        return self.hidden(tokens) @ self.w_out + self.b_out

    def accuracy(self, params, batch):
        return token_accuracy(self.logits(params, batch["x"]), batch["y"])
