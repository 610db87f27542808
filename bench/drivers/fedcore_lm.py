"""Entry ``fedcore_lm``: FedCore fine-tuning of a published LM through
the port's launcher, ``repro_torch.launch.train.train_fedcore_lm``, one
round a call, calls repeated until the window ends.

The launcher draws its weights, its silos' sequences and their
capabilities from its ``seed``.  So every seed does the same work, the
run's seed picks the launcher's: the first seed from it whose round has
the traffic's one straggler silo with the traffic's coreset budget
(``bench.inputs.lm_stream.plan``, the launcher's rule).  Set-up makes the
first call, whose outputs (the round's loss, the straggler's coreset and
the params' change) the reference judges once the window has closed.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Dict, List

import numpy as np

from bench.harness.compare import (Number, leaf_gaps, leaf_norms,
                                   moving_leaves, worst_and_median)
from bench.inputs.lm_init import init_dense_lm
from bench.inputs.lm_stream import plan
from bench.reference import fedcore_lm as ref_lm
from bench.reference import llama

K7, K8 = "flash_attention", "rmsnorm"
SEARCH = 100_000


def launcher_seed(seed: int, traffic: Dict) -> int:
    """The first of the seeds drawn from ``seed`` (SeedSequence((seed,
    j)), j = 0, 1, ...) whose round has exactly the traffic's stragglers,
    each with the traffic's budget."""
    want = traffic["coreset_budget"]
    for j in range(SEARCH):
        lo, hi = np.random.SeedSequence((seed, j)).generate_state(2)
        s = (int(hi) << 30) ^ int(lo)
        _, budgets = plan(traffic["silos"], traffic["steps_per_epoch"],
                          traffic["batch"], traffic["straggler_pct"], s,
                          ref_lm.EPOCHS)
        if (len(budgets) == traffic["stragglers"]
                and all(b == want for b in budgets.values())):
            return s
    raise ValueError(f"no launcher seed drawn from {seed} gives budget "
                     f"{want}")


class Driver:
    range_names = ()

    def __init__(self, cell: Dict, config: Dict, seed: int, device):
        import torch
        self.torch = torch
        self.cell, self.config = cell, config
        self.traffic = cell["traffic_params"]
        self.device = torch.device(device)
        self.seed = launcher_seed(seed % (1 << 62), self.traffic)
        self.calls: List = []        # (kernel, shape) of the profiled round

    def _model_config(self):
        from repro_torch.configs.base import ModelConfig
        c = self.config
        return ModelConfig(
            arch_id=c["arch_id"], family="dense", n_layers=c["n_layers"],
            d_model=c["d_model"], n_heads=c["n_heads"],
            n_kv_heads=c["n_kv_heads"], d_head=c["d_head"],
            d_ff=c["d_ff"], vocab_size=c["vocab_size"],
            norm_eps=c["norm_eps"], rope_theta=c["rope_theta"],
            tie_embeddings=False)

    def _call(self):
        from repro_torch.launch.train import train_fedcore_lm
        t = self.traffic
        out = train_fedcore_lm(
            self.mcfg, rounds=1, steps_per_epoch=t["steps_per_epoch"],
            silos=t["silos"], batch=t["batch"], seq=t["seq"], lr=t["lr"],
            straggler_pct=t["straggler_pct"], seed=self.seed,
            device=self.device)
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        return out

    def setup(self) -> None:
        self.mcfg = self._model_config()
        out = self._call()
        self.loss = float(out["history"][0]["loss"])
        self.coresets = {int(s): list(v) for s, v in
                         out["coresets"][0].items()}
        params = out["params"]
        del out
        init = init_dense_lm(self.torch, self.config, self.seed, self.device)
        self.change = leaf_norms(params, init)
        del params, init
        gc.collect()

    def run_round(self) -> None:
        out = self._call()
        del out

    def close_program(self) -> None:
        gc.collect()

    @contextlib.contextmanager
    def profiling(self):
        """The arguments' shapes of every call of kernels 7 and 8, kept in
        call order through the port's public wrappers (read by
        ``roofline_pct.lm_kernels``)."""
        from repro_torch.kernels import ops
        fa, rn = ops.flash_attention, ops.rmsnorm
        self.calls = []

        def flash_attention(q, k, v, **kw):
            self.calls.append((K7, tuple(q.shape), tuple(k.shape),
                               kw.get("causal", True)))
            return fa(q, k, v, **kw)

        def rmsnorm(x, scale, **kw):
            self.calls.append((K8, tuple(x.shape)))
            return rn(x, scale, **kw)
        ops.flash_attention, ops.rmsnorm = flash_attention, rmsnorm
        try:
            yield
        finally:
            ops.flash_attention, ops.rmsnorm = fa, rn

    def flops_per_round(self) -> float:
        """Model FLOPs a round: 3 forward passes for every sequence trained
        (E epochs of a full silo; one epoch and one coreset step of
        ``budget`` sequences of a straggler), one forward pass and the
        feature product (all positions' (softmax − onehot)·W_outᵀ) for
        every sequence of a straggler's feature pass."""
        c, t = self.config, self.traffic
        fwd_seq = llama.forward_flops_per_token(c, t["seq"]) * t["seq"]
        feat_seq = fwd_seq + 2.0 * t["seq"] * c["vocab_size"] * c["d_model"]
        _, budgets = plan(t["silos"], t["steps_per_epoch"], t["batch"],
                          t["straggler_pct"], self.seed, ref_lm.EPOCHS)
        m = t["steps_per_epoch"] * t["batch"]
        total = 0.0
        for s in range(t["silos"]):
            if s in budgets:
                total += 3.0 * fwd_seq * (m + budgets[s]) + feat_seq * m
            else:
                total += 3.0 * fwd_seq * ref_lm.EPOCHS * m
        return total

    def context(self) -> Dict:
        return {"calls": self.calls, "groups": []}

    def check(self, limits: Dict[str, float], details: Dict = None
              ) -> List[Number]:
        return judge(self.config, self.traffic, self.seed, self.device,
                     self.loss, self.coresets, self.change, limits, details)

    def repeat_gaps(self, other: "Driver") -> Dict[str, float]:
        """The worst-leaf change gap and the loss gap between two runs of
        the program on the same seed: its own run-to-run spread."""
        chg = worst_and_median(leaf_gaps(self.change, other.change,
                                         list(self.change)))[0]
        return {"change_gap": chg,
                "loss_gap": abs(self.loss - other.loss) / abs(other.loss),
                "same_coresets": float(self.coresets == other.coresets)}


def judge(config, traffic, seed, device, loss, coresets, change,
          limits, details: Dict = None) -> List[Number]:
    """Numbers of an LM cell: the round's reported loss (the last silo's
    last step), the params' change over the round by the worst leaf and
    by the median leaf, and
    for the straggler silos the followed medoids' excess over the
    reference's own k-medoids objective (their mean; a set that is not
    ``budget`` distinct sequences scores worse there).  ``details``, where
    given, receives every leaf's gap."""
    ref = ref_lm.lm_round(config, traffic, seed, device, follow=coresets)
    leaves = moving_leaves(ref.change)
    gaps = leaf_gaps(change, ref.change, leaves)
    if details is not None:
        details["change"] = gaps
    chg, at, med = worst_and_median(gaps)
    return [Number("loss_gap", abs(loss - ref.loss) / abs(ref.loss),
                   limits["loss_gap"]),
            Number("change_gap", chg, limits["change_gap"], at),
            Number("change_gap_med", med, limits["change_gap_med"]),
            Number("coreset_gap",
                   float(np.mean(ref.obj_gap)) if ref.obj_gap else 0.0,
                   limits["coreset_gap"])]


# -- the control and the planted faults (bench/calibrate.py, bench/tests) --

def control_outputs(cell: Dict, config: Dict, seed: int, device,
                    details: Dict = None):
    """The reference put in the program's place with TF32 products (the
    precision below the configuration's float32), its k-medoids in
    float32 on its own TF32 features."""
    import torch

    from bench.harness import env
    traffic = cell["traffic_params"]
    seed = launcher_seed(seed % (1 << 62), traffic)
    env.tf32_on(torch)
    try:
        out = ref_lm.lm_round(config, traffic, seed, device,
                              solve_dtype=torch.float32)
    finally:
        env.fp32_exact(torch)
    coresets = {s: v.tolist() for s, v in out.medoids.items()}
    return judge(config, traffic, seed, device, out.loss, coresets,
                 out.change, cell["limits"], details)


@contextlib.contextmanager
def fault(name: str):
    """Break the launcher's timed path underneath the harness:

    * ``unchanged``: every SGD step returns its state unchanged;
    * ``half_batch``: every step's loss leaves out the second half of its
      batch and takes the mean over the rest;
    * ``altered_coreset``: a straggler's coreset is replaced, where it is
      selected, by its first ``budget`` sequences."""
    import repro_torch.core.coreset as cs
    import repro_torch.launch.train as tr
    import repro_torch.models.model as mm

    saved = []

    def patch(owner, attr, new):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    if name == "unchanged":
        inner = tr.make_train_step

        def make(*a, **kw):
            step = inner(*a, **kw)

            def frozen(params, opt_state, batch, prox_ref=None):
                _, opt_state, metrics = step(params, opt_state, batch,
                                             prox_ref)
                return params, opt_state, metrics
            return frozen
        patch(tr, "make_train_step", make)
    elif name == "half_batch":
        inner = mm.Model.loss

        def half(self, params, batch, **kw):
            w = batch.get("weights")
            if w is not None:
                w = w.clone()
                w[w.shape[0] // 2:] = 0.0
                batch = dict(batch, weights=w)
            return inner(self, params, batch, **kw)
        patch(mm.Model, "loss", half)
    elif name == "altered_coreset":
        inner = cs.build_coreset

        def altered(features, budget, **kw):
            c = inner(features, budget, **kw)
            first = np.arange(c.indices.shape[0])
            return cs.Coreset(indices=c.indices.new_tensor(first),
                              weights=c.weights, objective=c.objective,
                              assignment=c.assignment)
        patch(cs, "build_coreset", altered)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, old in reversed(saved):
            setattr(owner, attr, old)
