"""Client-update strategies: FedAvg, FedAvg-DS, FedProx, FedCore (Alg. 1).

A strategy consumes the round-start global params and a client's local data
+ hardware spec, and returns the locally-trained params together with the
*simulated* wall-clock time the update would have taken on that client
(work-units / capability — the paper's timing model, §3.1/§6.1).

Client datasets stay numpy dicts on the host; each padded batch is copied
to the trainer's device, and the parameters live there throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.coreset import (Coreset, FedCoreConfig, build_coreset,
                                      coreset_batch)
from repro_torch.core.gradients import grad_features
from repro_torch.data.batching import epoch_batches
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.cost import resolve_cost
from repro_torch.fed.simulator import ClientSpec
from repro_torch.models.training import make_train_step
from repro_torch.obs import get_recorder
from repro_torch.optim.optimizers import sgd


@dataclasses.dataclass
class ClientResult:
    params: Any
    n_samples: int          # aggregation weight basis (mⁱ)
    sim_time: float         # simulated seconds for this round
    used_coreset: bool = False
    coreset_size: int = 0
    epochs_done: float = 0.0
    final_loss: float = 0.0
    # True when even the §4.4 minimal plan (coreset of 1, single partial
    # epoch) cannot meet τ: the client trained anyway but finished late.
    deadline_violated: bool = False


def _pad_batch(batch: Dict[str, np.ndarray], batch_size: int
               ) -> Dict[str, np.ndarray]:
    """Pad final partial batches to a fixed shape with zero-weight rows
    (repeats of the last row)."""
    m = len(next(iter(batch.values())))
    if m == batch_size:
        if "weights" not in batch:
            batch = dict(batch, weights=np.ones(m, np.float32))
        return batch
    pad = batch_size - m
    out = {}
    for k, v in batch.items():
        out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
    w = (out["weights"].copy() if "weights" in batch
         else np.ones(batch_size, np.float32))
    w[m:] = 0.0
    out["weights"] = w.astype(np.float32)
    return out


class LocalTrainer:
    """Holds the train step shared by every client/strategy.

    ``cost`` prices one sample-visit for this model's workload (a
    ``repro_torch.fed.cost.WorkloadCostModel``, a per-sample scalar, or
    None for the legacy samples-cost-1.0 unit).  ``device=None`` means the
    CUDA card; pass ``device="cpu"`` to train on the CPU.
    """

    def __init__(self, model, lr: float, batch_size: int,
                 prox_mu: float = 0.0, cost=None, device: DeviceLike = None):
        self.model = model
        self.batch_size = batch_size
        self.prox_mu = prox_mu
        self.cost = resolve_cost(cost)
        self.device = resolve_device(device)
        self.opt = sgd(lr)
        self._step = make_train_step(model.loss, self.opt, prox_mu=prox_mu)

    def run_epochs(self, params, data, epochs: int, rng, prox_ref=None,
                   max_steps: Optional[int] = None):
        opt_state = self.opt.init(params)
        steps = 0
        last = None
        stop = False
        for _ in range(int(np.ceil(epochs))):
            for batch in epoch_batches(data, self.batch_size, rng):
                batch = _pad_batch(batch, self.batch_size)
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in batch.items()}
                params, opt_state, metrics = self._step(params, opt_state,
                                                        batch, prox_ref)
                last = metrics["loss"]
                steps += 1
                if max_steps is not None and steps >= max_steps:
                    stop = True
                    break
            if stop:
                break
        # one host sync for the last loss, not one per step
        return params, steps, 0.0 if last is None else float(last)


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

class Strategy:
    name = "base"

    def __init__(self, trainer: LocalTrainer):
        self.trainer = trainer

    def local_update(self, global_params, data, spec: ClientSpec,
                     deadline: float, epochs: int, rng
                     ) -> Optional[ClientResult]:
        raise NotImplementedError


class FedAvg(Strategy):
    """Vanilla FedAvg — deadline-oblivious (the straggler-exposed
    baseline)."""
    name = "fedavg"

    def local_update(self, global_params, data, spec, deadline, epochs, rng):
        params, _, loss = self.trainer.run_epochs(global_params, data,
                                                  epochs, rng)
        t = self.trainer.cost.full_round_time(spec.m, spec.c, epochs)
        return ClientResult(params, spec.m, t,
                            epochs_done=epochs, final_loss=loss)


class FedAvgDS(Strategy):
    """FedAvg with Deadline: stragglers are simply dropped from the round."""
    name = "fedavg_ds"

    def local_update(self, global_params, data, spec, deadline, epochs, rng):
        t = self.trainer.cost.full_round_time(spec.m, spec.c, epochs)
        if t > deadline:
            return None  # dropped
        params, _, loss = self.trainer.run_epochs(global_params, data,
                                                  epochs, rng)
        return ClientResult(params, spec.m, t, epochs_done=epochs,
                            final_loss=loss)


class FedProx(Strategy):
    """Proximal term + partial work: stragglers train as many samples as fit
    within τ (Li et al., 2020)."""
    name = "fedprox"

    def local_update(self, global_params, data, spec, deadline, epochs, rng):
        cost = self.trainer.cost
        full_t = cost.full_round_time(spec.m, spec.c, epochs)
        violated = False
        if full_t <= deadline:
            steps = None
            sim_t = full_t
            eff_epochs = float(epochs)
        else:
            samples_budget = cost.available_samples(spec.c, deadline)
            steps = max(1, int(samples_budget // self.trainer.batch_size))
            # honest timing: when even one batch exceeds the budget the
            # clamped steps=1 plan overruns τ — report the true duration
            # and flag the violation
            sim_t = cost.duration(steps * self.trainer.batch_size, spec.c)
            violated = sim_t > deadline * (1.0 + 1e-9)
            eff_epochs = steps * self.trainer.batch_size / spec.m
        params, _, loss = self.trainer.run_epochs(
            global_params, data, epochs, rng, prox_ref=global_params,
            max_steps=steps)
        return ClientResult(params, spec.m, sim_t, epochs_done=eff_epochs,
                            final_loss=loss, deadline_violated=violated)


class FedCore(Strategy):
    """Alg. 1: full-set first epoch -> gradient features -> k-medoids coreset
    -> E−1 coreset epochs (or the §4.4 forward-only fallback)."""
    name = "fedcore"

    def __init__(self, trainer: LocalTrainer, core_cfg: FedCoreConfig
                 | None = None):
        super().__init__(trainer)
        self.core_cfg = core_cfg or FedCoreConfig()

    def select_coreset(self, feats: torch.Tensor, budget: int) -> Coreset:
        """Eq. (5) on one client's features (the ``selection`` phase)."""
        cc = self.core_cfg
        return build_coreset(feats, budget, backend=cc.backend,
                             use_kernel=cc.use_kernel,
                             max_sweeps=cc.max_sweeps,
                             projection_dim=cc.projection_dim)

    def local_update(self, global_params, data, spec, deadline, epochs, rng):
        cost = self.trainer.cost
        obs = get_recorder()
        if not cost.needs_coreset(spec.m, spec.c, deadline, epochs):
            with obs.span("local_sgd", cid=spec.cid):
                params, _, loss = self.trainer.run_epochs(global_params,
                                                          data, epochs, rng)
            return ClientResult(params, spec.m,
                                cost.full_round_time(spec.m, spec.c, epochs),
                                epochs_done=epochs, final_loss=loss)

        with obs.span("grad_features", cid=spec.cid):
            feats = grad_features(self.trainer.model, global_params, data)
        # Alg. 1 primary schedule (full-set epoch 0 + E−1 coreset epochs at
        # the §4.2 budget) and the §4.4 fallback both live in
        # repro_torch.fed.cost
        plan = cost.primary_plan(spec.m, spec.c, deadline, epochs)
        can_full_first_epoch = plan is not None
        if plan is None:
            plan = cost.fallback_plan(spec.m, spec.c, deadline, epochs)
            if plan.violated and self.core_cfg.drop_infeasible:
                return None
        budget, eff_epochs = plan.budget, plan.eff_epochs
        work, violated = plan.work, plan.violated

        with obs.span("selection", cid=spec.cid, k=int(budget)) as sp:
            coreset = self.select_coreset(feats, budget)
            cdata = coreset_batch(data, coreset, spec.m)
            sp.attrs["device"] = str(coreset.indices.device)

        params = global_params
        loss = 0.0
        if can_full_first_epoch:
            with obs.span("local_sgd", cid=spec.cid):
                params, _, loss = self.trainer.run_epochs(params, data, 1,
                                                          rng)
            with obs.span("coreset_epochs", cid=spec.cid):
                params, _, loss = self.trainer.run_epochs(params, cdata,
                                                          epochs - 1, rng)
        else:
            with obs.span("coreset_epochs", cid=spec.cid):
                params, _, loss = self.trainer.run_epochs(params, cdata,
                                                          eff_epochs, rng)
        return ClientResult(params, spec.m, cost.duration(work, spec.c),
                            used_coreset=True, coreset_size=int(budget),
                            epochs_done=eff_epochs, final_loss=loss,
                            deadline_violated=violated)



STRATEGIES = {
    "fedavg": FedAvg,
    "fedavg_ds": FedAvgDS,
    "fedprox": FedProx,
    "fedcore": FedCore,
}
