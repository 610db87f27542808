"""Entry ``fleet_round``: synchronous FedCore rounds of the port's batched
fleet engine, ``repro_torch.fed.fleet.batched.run_fleet_round`` with one
``FleetEngine``, every client in every round.

Set-up draws the fleet from the seed with the benchmark's frozen
generators (``bench/inputs``): the configuration's population of client
sizes and capabilities is drawn once from its own seed, and the run's
seed permutes which client gets which (size, capability) pair and draws
the images, labels and the initial weights, so every seed does the same
amount of work on other data.  The budgets come from the port's
``straggler_deadline`` and ``nominal_budgets``, as ``run_fleet`` takes
them.  Set-up then runs the first ``checked_rounds`` rounds through the
window's own call; their outputs are what the reference judges once the
window has closed.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np

from bench.harness.compare import (Number, leaf_gaps, leaf_norms,
                                   moving_leaves, worst_and_median)
from bench.inputs.mnist_like import draw_clients, power_law_sizes
from bench.inputs.specs import sample_capabilities
from bench.reference import fleet as ref_fleet
from bench.reference import smallcnn as ref_cnn

# span names of the program that the metric readers look up
RANGES = ("cohort_build", "local_sgd", "coreset_group", "grad_features",
          "selection", "aggregate", "gather")


def population(config: Dict):
    """The fleet's client sizes and capabilities, drawn once from the
    configuration's population seed."""
    pop = config["population_seed"]
    sizes = power_law_sizes(config["clients"], config["mean_samples"],
                            config["std_samples"],
                            np.random.default_rng(pop), min_size=10)
    caps = sample_capabilities(config["clients"], np.random.default_rng(pop))
    return sizes.astype(np.int64), caps


def fleet_inputs(config: Dict, seed: int):
    """(sizes, caps, clients) of one run: the population permuted by the
    seed, then each client's data drawn from the same stream."""
    sizes, caps = population(config)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(sizes))
    sizes, caps = sizes[perm], caps[perm]
    clients = draw_clients(sizes, rng, n_classes=config["classes"],
                           digits_per_client=config["digits_per_client"],
                           size=config["image"], noise=config["noise"])
    return sizes, caps, clients


def init_params(config: Dict, seed: int, device, torch):
    """SmallCNN's initial weights, drawn on the device from the seed in
    one call: N(0, 0.1²) convolutions, N(0, 1/1568) head, zero biases."""
    c1, c2 = config["channels"]
    s = config["image"] // 4
    f, n_cls = s * s * c2, config["classes"]
    shapes = {"conv1": (c1, 1, 5, 5), "conv2": (c2, c1, 5, 5),
              "w_out": (f, n_cls)}
    scale = {"conv1": 0.1, "conv2": 0.1, "w_out": 1.0 / np.sqrt(f)}
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(int(np.prod(v)) for v in shapes.values()),
                       generator=g, device=device)
    out, at = {}, 0
    for name, shp in shapes.items():
        n = int(np.prod(shp))
        out[name] = flat[at:at + n].reshape(shp) * scale[name]
        at += n
    for name, n in (("b1", c1), ("b2", c2), ("b_out", n_cls)):
        out[name] = torch.zeros(n, device=device)
    return out


def spec_of(config: Dict, cell: Dict) -> ref_fleet.FleetSpec:
    return ref_fleet.FleetSpec(
        epochs=config["epochs"], batch=config["batch"], lr=config["lr"],
        max_sweeps=config["max_sweeps"],
        straggler_pct=cell["traffic_params"]["straggler_pct"])


class Driver:
    range_names = RANGES

    def __init__(self, cell: Dict, config: Dict, seed: int, device):
        import torch
        self.torch = torch
        self.cell, self.config = cell, config
        self.seed, self.device = seed, torch.device(device)
        self.spec = spec_of(config, cell)
        self.checked = int(cell["traffic_params"]["checked_rounds"])

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        torch = self.torch
        from repro_torch.fed.fleet import (ArraySpec, FleetConfig,
                                           FleetEngine, FleetWorkload,
                                           nominal_budgets)
        from repro_torch.fed.simulator import ClientSpec, straggler_deadline
        from repro_torch.models import SmallCNN

        cfg, sp = self.config, self.spec
        self.sizes, self.caps, self.clients = fleet_inputs(cfg, self.seed)
        self.init = init_params(cfg, self.seed, self.device, torch)
        specs = [ClientSpec(cid=i, m=int(m), c=float(c))
                 for i, (m, c) in enumerate(zip(self.sizes, self.caps))]
        deadline = straggler_deadline(specs, sp.epochs, sp.straggler_pct)
        self.budgets = nominal_budgets(specs, deadline, sp.epochs)
        size = cfg["image"]
        workload = FleetWorkload(
            name="cnn", model=SmallCNN(image_size=size,
                                       channels=tuple(cfg["channels"])),
            schema={"x": ArraySpec((size, size), "float32"),
                    "y": ArraySpec((), "int32")},
            make_clients=None, description="SmallCNN, pseudo-MNIST")
        self.engine = FleetEngine(workload, FleetConfig(
            epochs=sp.epochs, batch_size=sp.batch, lr=sp.lr,
            max_sweeps=sp.max_sweeps,
            materialize_below=cfg["materialize_below"], seed=self.seed),
            device=self.device)
        self.cids = list(range(len(self.sizes)))
        self.params = self.init
        self.kept = []          # (params, {cid: loss}, {cid: medoids})
        self.round = 0
        for _ in range(self.checked):
            stats = self._round()
            self.kept.append(({k: v.clone() for k, v in self.params.items()},
                              dict(zip(stats.cids.tolist(),
                                       stats.losses.tolist())),
                              dict(stats.medoids)))

    def _round(self):
        from repro_torch.fed.fleet.batched import run_fleet_round
        self.params, stats = run_fleet_round(
            self.engine, self.params, self.clients, self.cids, self.budgets,
            round_seed=self.round, mode="batched")
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        self.round += 1
        return stats

    # -- window ------------------------------------------------------------
    def run_round(self) -> None:
        self._round()

    def close_program(self) -> None:
        self.engine = None
        self.params = None

    # -- what the metric readers need --------------------------------------
    def groups(self):
        """[(M, k, C)] of the round's cohort groups, in the program's
        order, by the reference's grouping rule."""
        b = ref_fleet.budgets(self.sizes, self.caps, self.spec)
        return [(m, k, len(c)) for m, k, c in
                ref_fleet.groups(self.sizes, b, self.spec)]

    def flops_per_round(self) -> float:
        """Model FLOPs a round: 3 forward passes for every real sample
        trained (E full epochs, or one epoch and E − 1 coreset steps of k
        samples), one forward pass and the head's gradient product for
        every real sample whose features a straggler takes."""
        cfg, sp = self.config, self.spec
        fwd = ref_cnn.forward_flops(cfg["image"], tuple(cfg["channels"]), 5,
                                    cfg["classes"])
        s = cfg["image"] // 4
        feat = fwd + 2.0 * cfg["classes"] * s * s * cfg["channels"][1]
        b = ref_fleet.budgets(self.sizes, self.caps, self.spec)
        total = 0.0
        for m_pad, k, cids in ref_fleet.groups(self.sizes, b, self.spec):
            m = float(self.sizes[cids].sum())
            if k == 0:
                total += 3.0 * fwd * sp.epochs * m
            else:
                total += (3.0 * fwd * (m + (sp.epochs - 1) * k * len(cids))
                          + feat * m)
        return total

    def context(self) -> Dict:
        return {"groups": self.groups(),
                "feature_width": (self.config["image"] // 4) ** 2
                * self.config["channels"][1]}

    # -- correctness -------------------------------------------------------
    def check(self, limits: Dict[str, float], details: Dict = None
              ) -> List[Number]:
        """The reference's rounds from the same start, inputs and seed,
        against the kept rounds (see ``judge``)."""
        return judge(self.kept, self.init, self.clients, self.sizes,
                     self.caps, self.spec, self.seed, self.device, limits,
                     details)

    def repeat_gaps(self, other: "Driver") -> Dict[str, float]:
        """Worst-leaf gaps and the loss gap between two runs of the
        program on the same seed: its own run-to-run spread."""
        a, b = self.kept, other.kept
        upd = worst_and_median(leaf_gaps(leaf_norms(a[0][0], self.init),
                                         leaf_norms(b[0][0], self.init),
                                         list(self.init)))[0]
        chg = worst_and_median(leaf_gaps(leaf_norms(a[-1][0], self.init),
                                         leaf_norms(b[-1][0], self.init),
                                         list(self.init)))[0]
        la = np.mean(list(a[0][1].values()))
        lb = np.mean(list(b[0][1].values()))
        same = np.mean([np.array_equal(a[0][2][c], b[0][2][c])
                        for c in a[0][2]]) if a[0][2] else 1.0
        return {"update_gap": upd, "change_gap": chg,
                "loss_gap": abs(la - lb) / abs(lb),
                "same_medoid_share": float(same)}


def judge(kept, init, clients, sizes, caps, spec, seed, device,
          limits: Dict[str, float], details: Dict = None) -> List[Number]:
    """Numbers of a fleet cell: the mean of the last local losses of the
    first round's full-set clients, the first round's update and the
    change over all checked rounds by
    the worst leaf and by the median leaf, and for stragglers the mean
    over them of the followed medoids' relative excess over the
    reference's own k-medoids objective (a set that is not k distinct
    real samples scores worse there).  ``details``, where given, receives
    every leaf's gaps."""
    p = init
    loss_gap, ref_params, obj = 0.0, [], []
    for r, (_, losses, medoids) in enumerate(kept):
        out = ref_fleet.fleet_round(p, clients, sizes, caps, spec, seed, r,
                                    device, follow=medoids)
        if r == 0:
            # the first round's clients that train on their full set: the
            # same start, data and steps on both sides (a straggler's
            # coreset epochs take the cluster sizes each side works out)
            full = [c for c in sorted(losses) if c not in medoids]
            prog_mean = float(np.mean([losses[c] for c in full]))
            ref_mean = float(np.mean([out.losses[c] for c in full]))
            loss_gap = abs(prog_mean - ref_mean) / max(abs(ref_mean), 1e-30)
        if details is not None:
            cs = sorted(losses)
            a = float(np.mean([losses[c] for c in cs]))
            b = float(np.mean([out.losses[c] for c in cs]))
            details.setdefault("loss_by_round", []).append(
                abs(a - b) / abs(b))
        obj += list(out.obj_gap.values())
        p = out.params
        ref_params.append(p)
    first_ref = leaf_norms(ref_params[0], init)
    leaves = moving_leaves(first_ref)
    gaps = {"update": leaf_gaps(leaf_norms(kept[0][0], init), first_ref,
                                leaves),
            "change": leaf_gaps(leaf_norms(kept[-1][0], init),
                                leaf_norms(ref_params[-1], init), leaves)}
    nums = [Number("loss_gap", loss_gap, limits["loss_gap"])]
    for tag, g in gaps.items():
        worst, at, med = worst_and_median(g)
        nums += [Number(f"{tag}_gap", worst, limits[f"{tag}_gap"], at),
                 Number(f"{tag}_gap_med", med, limits[f"{tag}_gap_med"])]
        if details is not None:
            details[tag] = g
    if spec.straggler_pct > 0:
        if details is not None:
            details["coreset_gaps"] = sorted(obj)[-5:]
        nums.append(Number("coreset_gap",
                           float(np.mean(obj)) if obj else 0.0,
                           limits["coreset_gap"]))
    return nums


# -- the control and the planted faults (bench/calibrate.py, bench/tests) --

def control_outputs(cell: Dict, config: Dict, seed: int, device,
                    details: Dict = None):
    """The reference put in the program's place, in the nearest precision
    below the configuration's float32: TF32 products and convolutions,
    and its k-medoids in float32 on its own TF32 features.  Returns the
    checked rounds' outputs as the program's are kept."""
    import torch

    from bench.harness import env
    spec = spec_of(config, cell)
    sizes, caps, clients = fleet_inputs(config, seed)
    init = init_params(config, seed, device, torch)
    kept, p = [], init
    env.tf32_on(torch)
    try:
        for r in range(int(cell["traffic_params"]["checked_rounds"])):
            out = ref_fleet.fleet_round(p, clients, sizes, caps, spec, seed,
                                        r, device,
                                        solve_dtype=torch.float32)
            kept.append((out.params, out.losses, out.medoids))
            p = out.params
    finally:
        env.fp32_exact(torch)
    return judge(kept, init, clients, sizes, caps, spec, seed, device,
                 cell["limits"], details)


@contextlib.contextmanager
def fault(name: str):
    """Break the program's timed path underneath the harness:

    * ``unchanged``: a round returns its start params;
    * ``half_batch``: the server's mean leaves out every second client
      of each group and takes the mean over the rest;
    * ``altered_coreset``: every straggler's medoids are replaced, where
      they are selected, by its first k samples."""
    import repro_torch.fed.fleet.batched as fb
    from repro_torch.core.coreset import Coreset

    saved = []

    def patch(owner, attr, new):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    if name == "unchanged":
        inner = fb.run_fleet_round

        def unchanged(engine, params, *a, **kw):
            return params, inner(engine, params, *a, **kw)[1]
        patch(fb, "run_fleet_round", unchanged)
    elif name == "half_batch":
        inner = fb._aggregate_groups

        def half(partials, fallback):
            return inner([(s, np.where(np.arange(len(w)) % 2 == 0, w, 0.0))
                          for s, w in partials], fallback)
        patch(fb, "_aggregate_groups", half)
    elif name == "altered_coreset":
        inner = fb.FleetEngine._select

        def altered(self, feats, valid, k):
            cs = inner(self, feats, valid, k)
            first = np.broadcast_to(np.arange(cs.indices.shape[1]),
                                    cs.indices.shape)
            return Coreset(indices=cs.indices.new_tensor(first),
                           weights=cs.weights, objective=cs.objective,
                           assignment=cs.assignment)
        patch(fb.FleetEngine, "_select", altered)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, old in reversed(saved):
            setattr(owner, attr, old)
