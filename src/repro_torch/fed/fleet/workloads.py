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

The JAX package's ``xlstm`` and ``translm`` workloads are not ported yet;
``get_workload`` names the ROADMAP slice that brings each.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.data import (mnist_like_dataset, shakespeare_like_dataset,
                              synthetic_dataset)
from repro_torch.data.charlm import VOCAB
from repro_torch.device import DeviceLike
from repro_torch.models.small import CharLSTM, LogisticRegression, SmallCNN

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


def _charlm_workload() -> FleetWorkload:
    def make_clients(n_clients: int = 64, seed: int = 0,
                     mean_samples: float = 40.0, std_samples: float = 24.0
                     ) -> List[ClientData]:
        return shakespeare_like_dataset(n_clients=n_clients,
                                        mean_samples=mean_samples,
                                        std_samples=std_samples,
                                        seq_len=_CHARLM_SEQ_LEN, seed=seed)

    return FleetWorkload(
        name="charlm",
        model=CharLSTM(vocab=VOCAB, d_embed=8, d_hidden=32, n_layers=1),
        schema={"x": ArraySpec((_CHARLM_SEQ_LEN,), "int32"),
                "y": ArraySpec((_CHARLM_SEQ_LEN,), "int32")},
        make_clients=make_clients,
        description="CharLSTM next-character prediction on the "
                    "Shakespeare-style char-LM task")


WORKLOADS: Dict[str, Callable[[], FleetWorkload]] = {
    "mlp": _mlp_workload,
    "cnn": _cnn_workload,
    "charlm": _charlm_workload,
}

# the JAX package's other workloads, and the ROADMAP slice that ports each
NOT_PORTED = {
    "xlstm": "slice 2b (models/xlstm.py's mLSTM block)",
    "translm": "slice 4 (models/attention.py and the flash-attention "
               "kernel)",
}


def get_workload(name: str) -> FleetWorkload:
    """Materialize a registered workload by name."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"fleet workload {name!r} is not ported yet: ROADMAP "
            f"{NOT_PORTED[name]}")
    try:
        return WORKLOADS[name]()
    except KeyError:
        raise ValueError(f"unknown fleet workload {name!r} "
                         f"(expected one of {sorted(WORKLOADS)})") from None
