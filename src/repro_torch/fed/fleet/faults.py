"""Seeded, deterministic fault injection for fleet-scale FL.

A fleet fails in more ways than slowness (the only axis the scenario
registry models): clients drop mid-round, join and leave between rounds,
send noisy or adversarial updates, and hold label-skewed non-IID data.
Each is an orthogonal, composable axis that any capability scenario can
be crossed with:

  * **mid-round dropout** — the client completes its dispatch (the work
    happens, the capability-trace entry is consumed, the scheduler
    observes the duration) but the *update* is lost with probability p
    before it reaches the server;
  * **join/leave churn** — per-round Bernoulli arrival/departure over the
    whole client universe (a two-state Markov chain per client), so the
    active set is a moving subset of a larger population;
  * **update corruption** — a fixed Byzantine subset of clients sends
    Gaussian-noised, sign-flipped, or scaled/boosted models every time it
    participates (the attack models Krum / trimmed-mean aggregation
    defends against);
  * **label-skew partitioning** — ``dirichlet_label_skew`` resamples a
    federated dataset so each client's label distribution follows a
    Dirichlet(α) draw.  This axis transforms the *dataset* before a run
    (``run_scenario`` applies it); the runtime axes above act per
    dispatch or round.

Every axis is a pure function of ``(seed, profile, cid, index)``: dropout
draws come from per-client streams indexed by the client's own dispatch
ordinal, churn masks from per-round streams, Byzantine membership from
one draw at construction.  The draws are numpy's, from the JAX package's
``SeedSequence`` streams, so both packages inject the same faults.
Gaussian noise is drawn one array per leaf in the JAX package's leaf
order and layout (``repro_torch.utils.tree.reference_leaves``) and
mapped back onto the port's leaves.

Fault events surface through ``repro_torch.obs``: counters
``faults.dropped_updates`` / ``faults.corrupted_updates`` /
``faults.churn_joins`` / ``faults.churn_leaves`` and per-round gauges
``faults.n_present`` / ``faults.participation_frac``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import Params, reference_keys

# stream tags: disjoint SeedSequence lanes per fault axis, so axes are
# independent and adding one never shifts another's draws
_TAG_BYZANTINE = 0xB1
_TAG_DROPOUT = 0xD0
_TAG_CHURN = 0xC4
_TAG_NOISE = 0x6E
_TAG_SKEW = 0x5C

CORRUPT_MODES = ("none", "gaussian", "sign_flip", "scaled")


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """One named combination of fault axes (all default off)."""
    name: str = "none"
    description: str = ""
    # P(update lost | dispatch completed) — per (client, dispatch)
    dropout_prob: float = 0.0
    # per-round churn Markov chain over the client universe
    leave_prob: float = 0.0       # P(present -> absent) per round
    join_prob: float = 0.0        # P(absent -> present) per round
    initial_present_frac: float = 1.0   # universe fraction present at t=0
    # Byzantine update corruption (fixed client subset)
    corrupt_mode: str = "none"    # none | gaussian | sign_flip | scaled
    corrupt_frac: float = 0.0     # fraction of Byzantine clients
    noise_std: float = 0.5        # gaussian: additive N(0, std^2) per weight
    scale_factor: float = 10.0    # scaled: delta boosted by this factor
    # non-IID label skew (data-prep axis; None = leave the data as built)
    label_skew_alpha: Optional[float] = None
    seed: int = 0                 # profile salt, mixed with the run seed

    def __post_init__(self):
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r} "
                             f"(expected one of {CORRUPT_MODES})")

    @property
    def has_dropout(self) -> bool:
        return self.dropout_prob > 0.0

    @property
    def has_churn(self) -> bool:
        return (self.leave_prob > 0.0 or self.join_prob > 0.0
                or self.initial_present_frac < 1.0)

    @property
    def has_corruption(self) -> bool:
        return self.corrupt_mode != "none" and self.corrupt_frac > 0.0

    def any_faults(self) -> bool:
        """True when any *runtime* axis is active (label skew is a
        data-prep axis and does not need a FaultTrace)."""
        return self.has_dropout or self.has_churn or self.has_corruption


FAULT_PROFILES: Dict[str, FaultProfile] = {p.name: p for p in [
    FaultProfile("none", "no faults"),
    FaultProfile("dropout",
                 "20% of completed updates are lost mid-round",
                 dropout_prob=0.2),
    FaultProfile("churn",
                 "70% of the universe present at t=0; 15%/25% per-round "
                 "leave/join rates",
                 leave_prob=0.15, join_prob=0.25, initial_present_frac=0.7),
    FaultProfile("byzantine_signflip",
                 "20% of clients send sign-flipped updates",
                 corrupt_mode="sign_flip", corrupt_frac=0.2),
    FaultProfile("byzantine_noise",
                 "20% of clients add N(0, 0.5^2) noise to every weight",
                 corrupt_mode="gaussian", corrupt_frac=0.2, noise_std=0.5),
    FaultProfile("byzantine_boost",
                 "10% of clients send 10x-boosted update deltas",
                 corrupt_mode="scaled", corrupt_frac=0.1, scale_factor=10.0),
    FaultProfile("label_skew",
                 "Dirichlet(0.3) label-skew non-IID partitioning",
                 label_skew_alpha=0.3),
    FaultProfile("hostile",
                 "everything at once: dropout + churn + 20% sign-flip "
                 "Byzantine + Dirichlet(0.5) label skew",
                 dropout_prob=0.1, leave_prob=0.1, join_prob=0.2,
                 initial_present_frac=0.8, corrupt_mode="sign_flip",
                 corrupt_frac=0.2, label_skew_alpha=0.5),
]}


def get_fault_profile(profile) -> Optional[FaultProfile]:
    """Coerce None | registry name | FaultProfile into a profile."""
    if profile is None:
        return None
    if isinstance(profile, FaultProfile):
        return profile
    if isinstance(profile, str):
        try:
            return FAULT_PROFILES[profile]
        except KeyError:
            raise ValueError(
                f"unknown fault profile {profile!r} "
                f"(expected one of {sorted(FAULT_PROFILES)})") from None
    raise TypeError(f"cannot derive a fault profile from "
                    f"{type(profile).__name__}")


def make_fault_trace(faults, n_clients: int, seed: int
                     ) -> Tuple[Optional["FaultTrace"], str]:
    """(the run's ``FaultTrace`` or None when no runtime axis is on, the
    profile's name) for a runtime's ``faults`` argument."""
    profile = get_fault_profile(faults)
    name = profile.name if profile is not None else "none"
    if profile is None or not profile.any_faults():
        return None, name
    return FaultTrace(profile, n_clients, seed=seed), name


class FaultTrace:
    """Deterministic per-run realization of a ``FaultProfile``.

    Dropout is drawn from per-client streams indexed by the client's own
    dispatch ordinal, churn from per-round streams, and Byzantine
    membership once at construction, so every query is a pure function
    of ``(run seed, profile, cid, index)``.  The lazy caches only memoize
    those pure functions.
    """

    def __init__(self, profile: FaultProfile, n_clients: int, seed: int = 0):
        self.profile = profile
        self.n = int(n_clients)
        self._seed = (int(seed), int(profile.seed))
        self.byzantine = np.zeros(self.n, bool)
        if profile.has_corruption:
            n_bad = min(self.n, int(round(profile.corrupt_frac * self.n)))
            if n_bad > 0:
                rng = np.random.default_rng(np.random.SeedSequence(
                    (*self._seed, _TAG_BYZANTINE)))
                self.byzantine[rng.choice(self.n, size=n_bad,
                                          replace=False)] = True
        self._drop_draws: Dict[int, List[float]] = {}
        self._present: List[np.ndarray] = []

    # -- dropout ----------------------------------------------------------

    def dropped(self, cid: int, dispatch_index: int) -> bool:
        """Was this (client, dispatch)'s update lost in transit?"""
        if not self.profile.has_dropout:
            return False
        draws = self._drop_draws.setdefault(int(cid), [])
        # one fresh stream per ordinal: only (cid, dispatch_index) matters
        while len(draws) <= dispatch_index:
            rng = np.random.default_rng(np.random.SeedSequence(
                (*self._seed, _TAG_DROPOUT, int(cid), len(draws))))
            draws.append(float(rng.random()))
        return draws[dispatch_index] < self.profile.dropout_prob

    # -- churn ------------------------------------------------------------

    def present_mask(self, t: int) -> np.ndarray:
        """(n,) bool universe-presence mask for round/flush ``t``."""
        if not self.profile.has_churn:
            return np.ones(self.n, bool)
        while len(self._present) <= t:
            r = len(self._present)
            rng = np.random.default_rng(np.random.SeedSequence(
                (*self._seed, _TAG_CHURN, r)))
            if r == 0:
                frac = self.profile.initial_present_frac
                mask = (np.ones(self.n, bool) if frac >= 1.0
                        else rng.random(self.n) < frac)
            else:
                prev = self._present[-1]
                u = rng.random(self.n)
                mask = np.where(prev, u >= self.profile.leave_prob,
                                u < self.profile.join_prob)
            self._present.append(mask)
        return self._present[t]

    def churn_step(self, t: int) -> Tuple[np.ndarray, int, int]:
        """Presence mask at ``t`` plus (joins, leaves) vs ``t - 1``."""
        mask = self.present_mask(t)
        if t <= 0 or not self.profile.has_churn:
            return mask, 0, 0
        prev = self.present_mask(t - 1)
        joins = int((mask & ~prev).sum())
        leaves = int((prev & ~mask).sum())
        return mask, joins, leaves

    # -- corruption -------------------------------------------------------

    def corrupt_factor(self) -> float:
        """Delta multiplier for a Byzantine client: corrupted params are
        ``base + factor * (params - base)`` (gaussian keeps factor 1 and
        adds noise instead)."""
        mode = self.profile.corrupt_mode
        if mode == "sign_flip":
            return -1.0
        if mode == "scaled":
            return float(self.profile.scale_factor)
        return 1.0

    def _noise_like(self, leaf_shapes, leaf_dtypes, cid: int,
                    dispatch_index: int) -> List[np.ndarray]:
        """Per-(client, dispatch) Gaussian noise, one array per leaf in
        the order given (the JAX package's flatten order)."""
        rng = np.random.default_rng(np.random.SeedSequence(
            (*self._seed, _TAG_NOISE, int(cid), int(dispatch_index))))
        std = self.profile.noise_std
        return [rng.normal(0.0, std, size=shape).astype(dt)
                for shape, dt in zip(leaf_shapes, leaf_dtypes)]


def _numpy_dtype(x: torch.Tensor) -> np.dtype:
    return torch.empty((), dtype=x.dtype).numpy().dtype


def _noise(params: Params, cid: int, dispatch_index: int,
           trace: FaultTrace, layouts) -> Dict[str, np.ndarray]:
    """{key: noise} for one client's leaves: each drawn in the JAX
    package's leaf order and layout (``layouts[key]`` takes the port's
    axes to the JAX ones), then laid out as the port's leaf."""
    layouts = layouts or {}
    keys = reference_keys(params)
    shapes = [tuple(params[k].shape[a] for a in layouts[k]) if k in layouts
              else tuple(params[k].shape) for k in keys]
    draws = trace._noise_like(shapes, [_numpy_dtype(params[k]) for k in keys],
                              cid, dispatch_index)
    return {k: (np.transpose(n, np.argsort(layouts[k])) if k in layouts
                else n) for k, n in zip(keys, draws)}


def corrupt_update(params: Params, base: Params, cid: int,
                   dispatch_index: int, trace: FaultTrace, layouts=None
                   ) -> Tuple[Params, bool]:
    """Corrupt one client's update if the client is Byzantine.

    Returns ``(params, corrupted?)``: an honest client's dict is returned
    unchanged (the same object).  ``layouts`` is the model's
    ``reference_layouts`` (the gaussian mode draws its noise in the JAX
    layout).  New tensors are built; neither input is changed."""
    if not trace.profile.has_corruption or not trace.byzantine[cid]:
        return params, False
    if trace.profile.corrupt_mode == "gaussian":
        noise = _noise(params, cid, dispatch_index, trace, layouts)
        return {k: x + torch.as_tensor(noise[k], device=x.device)
                for k, x in params.items()}, True
    f = trace.corrupt_factor()
    return {k: base[k] + f * (x - base[k]) for k, x in params.items()}, True


def corrupt_stacked(stacked: Params, base: Params, cids: np.ndarray,
                    dispatch_ix: np.ndarray, trace: FaultTrace,
                    layouts=None) -> Tuple[Params, int]:
    """Corrupt the Byzantine lanes of a (C, ...) stacked update dict.

    Only the corrupted lanes are rewritten, into a copy, so honest lanes
    stay bitwise identical to the engine's output.  Returns ``(stacked,
    n_corrupted)``."""
    if not trace.profile.has_corruption:
        return stacked, 0
    cids = np.asarray(cids, np.int64)
    idx = np.nonzero(trace.byzantine[cids])[0]
    if idx.size == 0:
        return stacked, 0
    first = next(iter(stacked.values()))
    ix = torch.as_tensor(idx, device=first.device)
    sub = {k: x[ix] for k, x in stacked.items()}
    if trace.profile.corrupt_mode == "gaussian":
        lanes = [_noise({k: x[0] for k, x in sub.items()}, int(c), int(d),
                        trace, layouts)
                 for c, d in zip(cids[idx], np.asarray(dispatch_ix)[idx])]
        sub = {k: x + torch.as_tensor(np.stack([n[k] for n in lanes]),
                                      device=x.device)
               for k, x in sub.items()}
    else:
        f = trace.corrupt_factor()
        sub = {k: base[k][None] + f * (x - base[k][None])
               for k, x in sub.items()}
    out = {}
    for k, x in stacked.items():
        out[k] = x.clone()
        out[k][ix] = sub[k]
    return out, int(idx.size)


# ---------------------------------------------------------------------------
# label-skew non-IID partitioning (data-prep axis)
# ---------------------------------------------------------------------------

def _label_keys(labels: np.ndarray) -> np.ndarray:
    """Scalar per-sample class key: the label itself, or the first token
    of a sequence label (char-LM workloads)."""
    labels = np.asarray(labels)
    if labels.ndim == 1:
        return labels
    return labels.reshape(labels.shape[0], -1)[:, 0]


def dirichlet_label_skew(clients_data: Sequence[Dict[str, np.ndarray]],
                         alpha: float, seed: int = 0, label_field: str = "y"
                         ) -> List[Dict[str, np.ndarray]]:
    """Repartition a federated dataset with Dirichlet(α) label skew.

    All samples are pooled, each client draws class proportions
    ``p_i ~ Dir(α · 1_K)`` over the pooled label set, and its ``m_i``
    slots are filled by sampling classes from ``p_i`` and popping
    shuffled per-class index pools (falling back to with-replacement
    resampling when a class pool runs dry).  Client sizes, and so every
    ``ClientSpec``, budget and deadline derived from them, are
    preserved; only *which* samples a client holds changes.  The draws
    and the returned bytes are the JAX package's (fields in sorted
    order, as its tree map returns them)."""
    if alpha <= 0.0:
        raise ValueError(f"dirichlet alpha must be > 0, got {alpha}")
    clients = list(clients_data)
    if not clients:
        return []
    if label_field not in clients[0]:
        raise ValueError(f"label-skew partitioning needs a {label_field!r} "
                         f"field in the client schema")
    pooled = {f: np.concatenate([np.asarray(c[f]) for c in clients])
              for f in sorted(clients[0])}
    keys = _label_keys(pooled[label_field])
    classes = np.unique(keys)
    rng = np.random.default_rng(np.random.SeedSequence(
        (int(seed), _TAG_SKEW)))
    pools = {}
    for cls in classes:
        ix = np.nonzero(keys == cls)[0]
        pools[int(cls)] = list(rng.permutation(ix))
    full = {int(cls): np.nonzero(keys == cls)[0] for cls in classes}
    k_cls = len(classes)
    out = []
    for client in clients:
        m = len(np.asarray(next(iter(client.values()))))
        props = rng.dirichlet(np.full(k_cls, float(alpha)))
        draws = rng.choice(k_cls, size=m, p=props)
        take = np.empty(m, np.int64)
        for j, ci in enumerate(draws):
            cls = int(classes[ci])
            pool = pools[cls]
            take[j] = pool.pop() if pool else int(rng.choice(full[cls]))
        out.append({f: v[take] for f, v in pooled.items()})
    return out
