"""Per-workload step cost: deadlines mean FLOPs, not samples (§4.2 honest).

FedCore's budget bⁱ = ⌊(cⁱτ − mⁱ)/(E−1)⌋ treats the deadline τ as a
*sample count* divided by a capability in samples/second — honest only
while every sample costs the same amount of compute.  The moment the
fleet runs a transformer next to an MLP that stops being true: a
capability cⁱ calibrated on one workload over- or under-commits on
another by exactly the ratio of their per-sample step costs.

This module makes the unit of work explicit.  A ``WorkloadCostModel``
carries the measured **cost per sample-visit** (one sample, one training
epoch) in abstract *cost units*; client capability cⁱ is cost units per
second.  Every budget/deadline formula in the repo routes through the
model:

  * ``available_samples(c, τ)`` — how many sample-visits fit in τ,
  * ``needs_coreset`` / ``budget`` — Alg. 1 line 6 and the §4.2 budget,
  * ``fallback_plan`` — the §4.4 forward-only plan with epoch shedding
    and footnote-2 honest-overrun accounting (previously copy-pasted
    between ``fed/strategies.py``, ``core/coreset.py`` callers, and
    ``fed/fleet/scheduler.py`` — this is now the one implementation),
  * ``duration`` / ``work_units`` — realized virtual-clock seconds and
    scheduler-EWMA work units from sample-visit counts.

**Legacy mode is byte-identical.**  The default ``UNIT_COST`` model
(cost_per_sample = 1.0) takes the exact arithmetic paths the formulas
used before this module existed — every branch below short-circuits the
×1.0 so goldens, BENCH gates, and event-log determinism are preserved
bit for bit.

Measurement: ``workload_cost_model`` prices a registered fleet
workload by the FLOPs of one local-SGD step (``measure_step_cost``,
counted by torch's ``FlopCounterMode``), relative to the mlp workload.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

# forward-only pass cost relative to a full train step (fwd+bwd+update);
# the §4.4 fallback charges the feature pass at this fraction
FORWARD_FRAC = 1.0 / 3.0


@dataclasses.dataclass(frozen=True)
class CostPlan:
    """One client's training plan for a round under (m, c, τ, E)."""
    budget: int          # coreset size b (samples)
    eff_epochs: int      # epochs actually run (≤ E: extreme stragglers shed)
    work: float          # sample-visits charged (feature pass + epochs)
    violated: bool       # True: even this minimal plan overruns τ


@dataclasses.dataclass(frozen=True)
class WorkloadCostModel:
    """Cost units per sample-visit for one workload.

    ``cost_per_sample`` is the knob everything keys off: 1.0 is the
    legacy samples-are-the-unit mode; a measured model carries the
    workload's per-sample step cost relative to the reference workload.
    ``flops_per_sample`` keeps the raw FLOPs a sample when the model came
    from ``measure_step_cost``'s count (None for legacy / wall-clock
    models).
    ``source`` ∈ {"legacy", "flops", "wallclock", "manual"}.
    """
    name: str = "unit"
    cost_per_sample: float = 1.0
    forward_frac: float = FORWARD_FRAC
    flops_per_sample: Optional[float] = None
    source: str = "legacy"

    @property
    def is_unit(self) -> bool:
        return self.cost_per_sample == 1.0

    # -- unit conversions --------------------------------------------------
    # Each conversion short-circuits ×1.0 / ÷1.0 so the unit model follows
    # the exact pre-refactor expressions (byte-identical legacy budgets).

    def available_samples(self, capability: float, deadline: float) -> float:
        """Sample-visits that fit in τ at capability c (cost units/s)."""
        avail = capability * deadline
        return avail if self.is_unit else avail / self.cost_per_sample

    def work_units(self, samples_visited) -> Any:
        """Cost units charged for visiting ``samples_visited`` samples."""
        if self.is_unit:
            return samples_visited
        return samples_visited * self.cost_per_sample

    def duration(self, samples_visited, capability) -> Any:
        """Virtual-clock seconds to visit ``samples_visited`` samples."""
        return self.work_units(samples_visited) / capability

    def full_round_time(self, m: int, capability: float, epochs: int
                        ) -> float:
        """E full-set epochs: the pre-coreset round time E·mⁱ·κ/cⁱ."""
        return self.duration(epochs * m, capability)

    # -- Alg. 1 budget arithmetic (the one implementation) -----------------

    def needs_coreset(self, m: int, capability: float, deadline: float,
                      epochs: int) -> bool:
        """Alg. 1 line 6: full-set training iff E·mⁱ sample-visits fit."""
        return epochs * m > self.available_samples(capability, deadline)

    def budget(self, m: int, capability: float, deadline: float,
               epochs: int) -> int:
        """bⁱ = ⌊(avail − mⁱ)/(E−1)⌋ clipped to [1, mⁱ] (paper §4.2)."""
        if epochs <= 1:
            return m
        avail = self.available_samples(capability, deadline)
        b = int(np.floor((avail - m) / (epochs - 1)))
        return max(1, min(b, m))

    def primary_plan(self, m: int, capability: float, deadline: float,
                     epochs: int) -> Optional[CostPlan]:
        """Alg. 1's primary schedule: full-set epoch 0 (which yields the
        gradient features) + E−1 coreset epochs at the §4.2 budget.
        Returns None when the budget floored at 1 still overruns τ — the
        caller falls back to ``fallback_plan``."""
        if epochs <= 1 or not self.available_samples(capability,
                                                     deadline) > m:
            return None
        b = self.budget(m, capability, deadline, epochs)
        work = m + (epochs - 1) * b
        if work > self.available_samples(capability, deadline):
            return None   # budget floored at 1 but still too slow
        return CostPlan(budget=b, eff_epochs=epochs, work=float(work),
                        violated=False)

    def fallback_plan(self, m: int, capability: float, deadline: float,
                      epochs: int) -> CostPlan:
        """§4.4 fallback: forward-only feature pass (``forward_frac`` of a
        train step per sample), coreset-only epochs, and epoch shedding
        for extreme stragglers.  ``violated`` implements footnote 2's
        honest accounting: when cⁱτ cannot even cover m/3 + b the client
        trains the minimal plan and the overrun is surfaced instead of
        silently clamping the reported time to τ."""
        avail = (self.available_samples(capability, deadline)
                 - self.forward_frac * m)
        budget = max(1, min(int(avail // epochs), m))
        eff_epochs = max(1, min(epochs, int(avail // budget)))
        work = self.forward_frac * m + eff_epochs * budget
        violated = bool(self.work_units(work)
                        > capability * deadline * (1.0 + 1e-9))
        return CostPlan(budget=budget, eff_epochs=eff_epochs, work=work,
                        violated=violated)


UNIT_COST = WorkloadCostModel()


def resolve_cost(cost: Any) -> WorkloadCostModel:
    """None → legacy unit model; a number → manual scalar model; a
    ``WorkloadCostModel`` passes through."""
    if cost is None:
        return UNIT_COST
    if isinstance(cost, WorkloadCostModel):
        return cost
    if isinstance(cost, (int, float, np.floating, np.integer)):
        return WorkloadCostModel(name=f"manual[{float(cost):g}]",
                                 cost_per_sample=float(cost),
                                 source="manual")
    raise TypeError(f"cannot resolve a cost model from {type(cost).__name__}")


# ---------------------------------------------------------------------------
# measurement: FLOPs of one SGD step (primary), wall clock for a count of 0
# ---------------------------------------------------------------------------

def example_batch(workload, batch_size: int = 8) -> Dict[str, torch.Tensor]:
    """A schema-shaped batch of zeros (and unit loss weights) on the CPU.

    FLOP counts depend on shapes, not values, so zeros are enough, also
    for the token fields (index 0 is a valid embedding row)."""
    batch = {name: torch.zeros((batch_size,) + tuple(spec.shape),
                               dtype=getattr(torch, spec.dtype))
             for name, spec in workload.schema.items()}
    batch["weights"] = torch.ones((batch_size,))
    return batch


def _sgd_step(model, params, batch, lr: float):
    """One local-SGD step (forward, backward, update): the arithmetic
    every fleet engine's inner loop runs."""
    ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total, _ = model.loss(ps, batch)
    grads = torch.autograd.grad(total, list(ps.values()))
    return {k: p - lr * g for (k, p), g in zip(ps.items(), grads)}


def measure_step_cost(model, batch, lr: float = 0.05,
                      timing_reps: int = 5) -> Tuple[float, str]:
    """(per-sample step cost, source) for one model on one example batch.

    Primary: the FLOPs of one SGD step as torch's ``FlopCounterMode``
    counts them, run on meta copies of the params and the batch: nothing
    is computed, and the count follows the shapes through the models'
    plain arithmetic, whatever the batch's device (a kernel launched
    through ``ctypes`` would be invisible to the counter, so the count
    never depends on what implements the work).  The JAX package counts
    its compiled step's HLO FLOPs instead, so the two packages' values
    differ; their order across workloads is what the budgets use.
    Fallback, for a step the counter sees no FLOPs in: the min wall time
    of ``timing_reps`` steps on the batch's device.  Either way the value
    is per *sample*, so dividing two workloads' costs cancels the unit.
    """
    n = int(next(iter(batch.values())).shape[0])
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with FlopCounterMode(display=False) as counter:
        _sgd_step(model, {k: v.to("meta") for k, v in params.items()},
                  {k: v.to("meta") for k, v in batch.items()}, lr)
    flops = counter.get_total_flops()
    if flops > 0:
        return flops / n, "flops"
    dev = next(iter(batch.values())).device
    params = {k: v.to(dev) for k, v in params.items()}
    _sgd_step(model, params, batch, lr)           # warm up
    best = float("inf")
    for _ in range(max(1, timing_reps)):
        t0 = time.perf_counter()
        _sgd_step(model, params, batch, lr)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best / n, "wallclock"


_MEASURED: Dict[Tuple[str, int], Tuple[float, str]] = {}


def _measured_workload_cost(workload, batch_size: int,
                            lr: float) -> Tuple[float, str]:
    key = (workload.name, batch_size)
    if key not in _MEASURED:
        _MEASURED[key] = measure_step_cost(
            workload, example_batch(workload, batch_size), lr=lr)
    return _MEASURED[key]


def workload_cost_model(workload, batch_size: int = 8, *,
                        relative_to: Any = "mlp",
                        lr: float = 0.05) -> WorkloadCostModel:
    """Measure a registered workload's cost model.

    ``workload`` is a ``FleetWorkload`` or a registry name.  Costs are
    normalized by ``relative_to``: a registry name (measured the same
    way; default ``"mlp"``, the original fleet workload whose samples the
    legacy capability unit priced at 1.0), a number, or None for raw
    per-sample units.  Measurements are cached per (workload,
    batch_size), so repeated calls measure nothing again."""
    from repro_torch.fed.fleet.workloads import get_workload
    if isinstance(workload, str):
        workload = get_workload(workload)
    value, source = _measured_workload_cost(workload, batch_size, lr)
    if isinstance(relative_to, str):
        ref = get_workload(relative_to)
        ref_value, ref_source = _measured_workload_cost(ref, batch_size, lr)
        if ref_source != source:
            # never mix FLOPs with seconds: re-measure both by wall clock
            value, source = measure_step_cost(
                workload, example_batch(workload, batch_size), lr=lr,
                timing_reps=5)
            ref_value, _ = measure_step_cost(
                ref, example_batch(ref, batch_size), lr=lr, timing_reps=5)
    elif relative_to is None:
        ref_value = 1.0
    else:
        ref_value = float(relative_to)
    return WorkloadCostModel(
        name=workload.name,
        cost_per_sample=value / ref_value,
        flops_per_sample=value if source == "flops" else None,
        source=source)
