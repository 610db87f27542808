"""A round of FedCore-for-LM (FedCore Alg. 1 at sequence granularity),
worked out again from the inputs alone: each silo trains the round-start
params with plain SGD for E = 2 epochs of its sequences in order, B at a
time; a straggler silo (see ``bench.inputs.lm_stream.plan``) instead
takes the last-layer-gradient features of its sequences at the
round-start params, selects ``budget`` medoids (BUILD + SWAP, at most
``max_sweeps``), trains one full epoch, then one full-batch step on the
medoids weighted by their cluster sizes.  The server's new params are
the plain mean of the silos'.

Where ``follow`` gives a straggler's medoids (the program's, to judge
them), its coreset step trains on those, weighted by their cluster sizes
here; its own solve then only scores them."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.inputs.lm_init import init_dense_lm
from bench.inputs.lm_stream import plan, silos
from bench.reference import kmedoids, llama

EPOCHS = 2


@dataclasses.dataclass
class LMRoundOut:
    loss: float                        # the last silo's last step's loss
    medoids: Dict[int, np.ndarray]     # silo -> medoids trained on
    change: Dict[str, float]           # leaf -> ‖params − init‖
    obj_gap: List[float]               # followed medoids' excess


def lm_round(cfg: Dict, traffic: Dict, seed: int, device,
             follow: Optional[Dict[int, List[int]]] = None,
             solve_dtype=torch.float64) -> LMRoundOut:
    dev = torch.device(device)
    init = init_dense_lm(torch, cfg, seed, dev)
    n, spe, b = traffic["silos"], traffic["steps_per_epoch"], traffic["batch"]
    data = silos(cfg["vocab_size"], n, spe, b, traffic["seq"], seed)
    _, budgets = plan(n, spe, b, traffic["straggler_pct"], seed, EPOCHS)
    lr, m = traffic["lr"], spe * b
    acc = {k: torch.zeros(v.shape, dtype=torch.float64, device=dev)
           for k, v in init.items()}
    out = LMRoundOut(0.0, {}, {}, [])
    ones = torch.ones(b, device=dev)
    for s in range(n):
        tok = torch.as_tensor(data[s]["tokens"], device=dev)
        lab = torch.as_tensor(data[s]["labels"], device=dev)
        p = init
        epochs = EPOCHS
        if s in budgets:
            k = budgets[s]
            with torch.no_grad():
                f = llama.grad_features(init, cfg, tok, lab)
                D = kmedoids.distances(f.to(solve_dtype)[None])
                valid = torch.ones((1, m), dtype=torch.bool, device=dev)
                own = kmedoids.solve(D, valid, k, traffic["max_sweeps"])
                med = own.medoids
                if follow is not None:
                    fm = np.asarray(follow[s], np.int64)
                    med = torch.as_tensor(fm.clip(0, m - 1), device=dev)[None]
                    obj = float(kmedoids.objective(D, valid, med)[0])
                    ref = float(own.objective[0])
                    out.obj_gap.append((obj - ref) / max(ref, 1e-12))
                w = kmedoids.cluster_sizes(D, valid, med)[0].float()
                out.medoids[s] = med[0].cpu().numpy()
                del f, D
            epochs = 1
        for _ in range(epochs):
            for lo in range(0, m, b):
                p, loss = llama.sgd_step(p, cfg, tok[lo:lo + b],
                                         lab[lo:lo + b], ones, lr)
        if s in budgets:
            ix = med[0]
            p, loss = llama.sgd_step(p, cfg, tok[ix], lab[ix], w, lr)
        for k2 in acc:
            acc[k2] += p[k2].double()
        del p
        out.loss = loss
    for k2, v in acc.items():
        out.change[k2] = float(torch.linalg.vector_norm(
            v / n - init[k2].double()))
    return out
