"""End-to-end training launcher of the port (one card).

Trains a decoder LM (any arch id's smoke variant, or a named preset) on
a synthetic token stream, with optional **FedCore-for-LM**:
the stream is split into "client silos"; silos whose per-round token
budget exceeds their simulated capability train on a coreset selected by
last-layer-gradient k-medoids — the paper's algorithm applied at LM
scale.

Examples:
  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny --steps 10

  # on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \
      --steps 10 --device cpu

  # federated with coresets (4 silos, 30% stragglers)
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \
      --fedcore --silos 4 --rounds 3 --steps 8
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_server_state
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model
from repro_torch.models.training import make_train_step
from repro_torch.obs import get_recorder
from repro_torch.optim.optimizers import adam, sgd
from repro_torch.optim.schedules import warmup_cosine_lr
from repro_torch.utils.tree import param_count, tree_weighted_mean

PRESETS = {
    "tiny": ModelConfig(arch_id="tiny-lm", family="dense", n_layers=2,
                        d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
                        vocab_size=512),
    "20m": ModelConfig(arch_id="lm-20m", family="dense", n_layers=6,
                       d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
                       vocab_size=8192),
    "100m": ModelConfig(arch_id="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                        vocab_size=32768),
}


def synthetic_stream(vocab: int, batch: int, seq: int, seed: int = 0,
                     device: DeviceLike = None):
    """Markov-ish synthetic token batches (learnable structure), drawn
    with the JAX package's numpy RNG calls in its order, so the tokens
    are byte for byte the reference's; int32 tensors on ``device``.  The
    batches hold tokens only, as the reference's: an audio or VLM model's
    forward finds no ``encoder_embeddings`` / ``patch_embeddings`` in
    them and raises ``KeyError``, in both packages."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # sparse bigram table
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
        yield {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
               "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev),
               "weights": torch.ones((batch,), dtype=torch.float32,
                                     device=dev)}


def train_centralized(cfg: ModelConfig, steps: int, batch: int, seq: int,
                      lr: float, ckpt_dir: Optional[str], log_every: int,
                      seed: int, device: DeviceLike = None,
                      use_kernel: Optional[bool] = None) -> Dict:
    """Adam under a warmup-cosine schedule, the gradients clipped to
    global norm 1; the final params checkpointed to ``ckpt_dir``
    (``repro_torch.checkpoint``, the JAX package's file format).  Returns
    the losses and the final ``params``."""
    dev = resolve_device(device)
    model = Model(cfg, use_kernel=use_kernel)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    n = param_count(params)
    print(f"[train] arch={cfg.arch_id} params={n/1e6:.1f}M "
          f"batch={batch} seq={seq}")
    opt = adam(warmup_cosine_lr(lr, max(1, steps // 20), steps))
    step_fn = make_train_step(model.loss, opt, clip_norm=1.0, donate=False)
    opt_state = opt.init(params)
    stream = synthetic_stream(cfg.vocab_size, batch, seq, seed, dev)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch_data = next(stream)
        params, opt_state, metrics = step_fn(params, opt_state, batch_data)
        losses.append(float(metrics["loss"]))
        if i % log_every == 0 or i == steps - 1:
            dt = time.perf_counter() - t0
            tput = (i + 1) * batch * seq / dt
            print(f"[train] step {i:5d} loss {losses[-1]:.4f} "
                  f"({tput:,.0f} tok/s)", flush=True)
    if ckpt_dir:
        save_server_state(ckpt_dir, steps, params,
                          extra={"arch": cfg.arch_id,
                                 "final_loss": losses[-1]})
        print(f"[train] checkpoint written to {ckpt_dir}")
    assert losses[-1] < losses[0], "training did not reduce loss"
    return {"initial_loss": losses[0], "final_loss": losses[-1],
            "losses": losses, "params": params}


def train_fedcore_lm(cfg: ModelConfig, rounds: int, steps_per_epoch: int,
                     silos: int, batch: int, seq: int, lr: float,
                     straggler_pct: float, seed: int,
                     device: DeviceLike = None,
                     use_kernel: Optional[bool] = None) -> Dict:
    """Federated LM fine-tuning with FedCore coreset selection per silo.

    Each silo holds ``steps_per_epoch * batch`` sequences; stragglers
    (slow silos) select a sequence-coreset via last-layer-gradient
    k-medoids (``build_coreset``: kernels 1–3 on the card) and train on
    it with weights δ — Alg. 1 at LM granularity.  ``use_kernel`` is the
    tri-state of the selection, the attention and the norms
    (``use_kernel=False`` on the card is the plain twin).  Returns the
    history, each round's coreset indices by straggler silo, and the
    final ``params``."""
    from repro_torch.core.coreset import build_coreset, coreset_batch
    from repro_torch.models.small import _last_layer_grad_feature

    obs = get_recorder()
    dev = resolve_device(device)
    with obs.span("lm_init"):
        model = Model(cfg, use_kernel=use_kernel)
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            dev)
        rng = np.random.default_rng(seed)
        opt = sgd(lr)
        step_fn = make_train_step(model.loss, opt, donate=False)

        # build silo datasets
        stream = synthetic_stream(cfg.vocab_size, batch, seq, seed, dev)
        silo_data = []
        for s in range(silos):
            seqs = [next(stream) for _ in range(steps_per_epoch)]
            silo_data.append({
                "tokens": torch.cat([b["tokens"] for b in seqs]),
                "labels": torch.cat([b["labels"] for b in seqs]),
            })
        caps = np.maximum(rng.normal(1.0, 0.5, silos), 0.2)
        m = steps_per_epoch * batch  # sequences per silo
        epochs = 2
        times_full = epochs * m / caps
        tau = float(np.percentile(times_full, 100 - straggler_pct))

    def features_fn(p, data):
        with torch.no_grad():
            logits, _, _ = model.forward(p, data)
            w = p["embed"].T if cfg.tie_embeddings else p["w_unembed"]
            return _last_layer_grad_feature(logits, data["labels"], w)

    def ones(bt):
        return torch.ones((bt["tokens"].shape[0],), dtype=torch.float32,
                          device=dev)

    def full_epoch(p_local, opt_state, data):
        for lo in range(0, m, batch):
            bt = {k: v[lo:lo + batch] for k, v in data.items()}
            bt["weights"] = ones(bt)
            p_local, opt_state, met = step_fn(p_local, opt_state, bt)
        return p_local, opt_state, met

    history, coresets = [], []
    for r in range(rounds):
        with obs.span("round", round=r):
            local_params = []
            round_time = 0.0
            n_core = 0
            chosen = {}
            for s in range(silos):
                data = silo_data[s]
                needs = epochs * m > caps[s] * tau
                p_local = params
                opt_state = opt.init(p_local)
                if needs:
                    budget = max(2, int((caps[s] * tau - m)
                                        // max(epochs - 1, 1)))
                    budget = min(budget, m)
                    with obs.span("coreset_group", silo=s, k=budget):
                        with obs.span("grad_features"):
                            feats = features_fn(params, data)
                        with obs.span("selection"):
                            cs = build_coreset(feats, budget,
                                               use_kernel=use_kernel)
                            chosen[s] = cs.indices.cpu().tolist()
                            cdata = coreset_batch(
                                {k: v.cpu().numpy() for k, v in data.items()},
                                cs, m)
                        n_core += 1
                        t = (m + (epochs - 1) * budget) / caps[s]
                        # 1 full epoch + (E-1) coreset epochs
                        with obs.span("sgd_steps", steps=steps_per_epoch):
                            p_local, opt_state, met = full_epoch(
                                p_local, opt_state, data)
                        with obs.span("coreset_epochs", steps=epochs - 1):
                            for _ in range(epochs - 1):
                                bt = {k: torch.from_numpy(v).to(dev)
                                      for k, v in cdata.items()}
                                p_local, opt_state, met = step_fn(
                                    p_local, opt_state, bt)
                else:
                    t = epochs * m / caps[s]
                    with obs.span("local_sgd", silo=s), \
                            obs.span("sgd_steps",
                                     steps=epochs * steps_per_epoch):
                        for _ in range(epochs):
                            p_local, opt_state, met = full_epoch(
                                p_local, opt_state, data)
                local_params.append(p_local)
                round_time = max(round_time, t)
            with obs.span("aggregate"):
                params = tree_weighted_mean(local_params, [1.0] * silos)
            loss = float(met["loss"])
            history.append({"round": r, "loss": loss,
                            "round_time": round_time, "tau": tau,
                            "coreset_silos": n_core})
            coresets.append(chosen)
            print(f"[fedcore-lm] round {r} loss {loss:.4f} "
                  f"time/tau {round_time/tau:.3f} coreset silos {n_core}",
                  flush=True)
    assert all(h["round_time"] <= tau * 1.001 for h in history), \
        "FedCore round exceeded deadline"
    return {"history": history, "coresets": coresets, "params": params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny",
                    choices=list(PRESETS) + ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    # federated mode
    ap.add_argument("--fedcore", action="store_true")
    ap.add_argument("--silos", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--straggler-pct", type=float, default=30.0)
    args = ap.parse_args(argv)

    cfg = PRESETS.get(args.preset) or get_config(args.preset, smoke=True)
    if args.fedcore:
        return train_fedcore_lm(cfg, args.rounds, args.steps, args.silos,
                                args.batch, args.seq, args.lr,
                                args.straggler_pct, args.seed, args.device)
    return train_centralized(cfg, args.steps, args.batch, args.seq, args.lr,
                             args.ckpt, args.log_every, args.seed,
                             args.device)


if __name__ == "__main__":
    main()
