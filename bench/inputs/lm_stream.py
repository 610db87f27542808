"""Frozen copies of the FedCore-for-LM launcher's draws
(``repro_torch.launch.train``): ``synthetic_stream``'s Markov-ish token
batches, the silos built from it and the silos' capabilities, in the
launcher's order, as numpy arrays.  ``bench/tests/check_inputs.py``
holds them to the port's bytes."""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def synthetic_stream(vocab: int, batch: int, seq: int, seed: int
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Token batches over a sparse bigram table (4 successors a token),
    10 % of the steps a uniform token instead; (batch, seq) int32
    ``tokens`` and next-token ``labels``."""
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, vocab, size=(vocab, 4))
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=batch)
        choice = rng.integers(0, 4, size=(batch, seq))
        noise = rng.random((batch, seq)) < 0.1
        rand = rng.integers(0, vocab, size=(batch, seq))
        for t in range(seq):
            nx = nxt[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nx)
        yield {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def silos(vocab: int, n_silos: int, steps_per_epoch: int, batch: int,
          seq: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """Each silo's ``steps_per_epoch * batch`` sequences, in turn."""
    stream = synthetic_stream(vocab, batch, seq, seed)
    out = []
    for _ in range(n_silos):
        parts = [next(stream) for _ in range(steps_per_epoch)]
        out.append({k: np.concatenate([p[k] for p in parts])
                    for k in ("tokens", "labels")})
    return out


def capabilities(n_silos: int, seed: int) -> np.ndarray:
    """The silos' simulated capabilities, N(1, 0.25) floored at 0.2."""
    return np.maximum(np.random.default_rng(seed).normal(1.0, 0.5, n_silos),
                      0.2)


def plan(n_silos: int, steps_per_epoch: int, batch: int,
         straggler_pct: float, seed: int, epochs: int = 2):
    """(τ, {silo: coreset budget}) of the launcher's round: a silo whose
    E·m sequence-visits exceed cⁱτ, τ the (100 − s)-th percentile of the
    full-round times, gets budget ⌊cⁱτ − m⌋ // (E − 1) in [2, m]."""
    caps = capabilities(n_silos, seed)
    m = steps_per_epoch * batch
    tau = float(np.percentile(epochs * m / caps, 100 - straggler_pct))
    out = {}
    for s in range(n_silos):
        if epochs * m > caps[s] * tau:
            out[s] = min(max(2, int((caps[s] * tau - m)
                                    // max(epochs - 1, 1))), m)
    return tau, out
