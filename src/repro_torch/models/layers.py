"""Initialisers shared by the port's models."""
from __future__ import annotations

import numpy as np
import torch


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> torch.Tensor:
    """(d_in, d_out) float32 N(0, 1)·scale, scale = 1/sqrt(d_in) by
    default — the JAX package's ``dense_init`` with a torch generator."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=generator,
                       dtype=torch.float32) * scale
