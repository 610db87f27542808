"""Shakespeare-style federated char-LM surrogate (Table 1: 143 clients =
speaking roles, mean 3616 samples/client, next-character prediction).

Text is drawn from a shared order-1 character Markov chain (English-like
bigram statistics synthesized from a seeded random sparse transition matrix)
with a per-client "style" perturbation of the transition probabilities —
giving the cross-client statistical heterogeneity of per-role text without
shipping the corpus.  Samples are (seq, next-seq) windows exactly like the
LEAF Shakespeare task.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.data.partition import power_law_sizes

VOCAB = 64  # reduced printable charset


def _base_chain(rng: np.random.Generator, vocab: int) -> np.ndarray:
    """Sparse-ish bigram transition matrix with Zipfian character marginals."""
    marg = 1.0 / np.arange(1, vocab + 1) ** 1.1
    marg /= marg.sum()
    T = rng.gamma(0.3, size=(vocab, vocab)) * marg[None, :]
    T /= T.sum(axis=1, keepdims=True)
    return T


def shakespeare_like_dataset(n_clients: int = 143, mean_samples: float = 3616.0,
                             std_samples: float = 6808.0, seq_len: int = 80,
                             style_temp: float = 0.4, seed: int = 0
                             ) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    T = _base_chain(rng, VOCAB)
    sizes = power_law_sizes(n_clients, mean_samples, std_samples, rng,
                            min_size=32)
    clients = []
    for i in range(n_clients):
        style = rng.gamma(1.0 / max(style_temp, 1e-3),
                          size=(VOCAB, VOCAB)) * style_temp
        Ti = T * style
        Ti /= Ti.sum(axis=1, keepdims=True)
        m = int(sizes[i])
        # one long stream, then windowed
        n_chars = m + seq_len + 1
        cum = np.cumsum(Ti, axis=1)
        chars = np.empty(n_chars, np.int32)
        chars[0] = rng.integers(VOCAB)
        u = rng.random(n_chars)
        for t in range(1, n_chars):
            chars[t] = np.searchsorted(cum[chars[t - 1]], u[t])
        x = np.lib.stride_tricks.sliding_window_view(
            chars[:-1], seq_len)[:m].copy()
        y = np.lib.stride_tricks.sliding_window_view(
            chars[1:], seq_len)[:m].copy()
        clients.append({"x": x.astype(np.int32), "y": y.astype(np.int32)})
    return clients
