"""Batched serving launcher of the port: prefill + KV-cache / recurrent
state decode with greedy / temperature sampling, for every family's
configs.  As in the JAX package, an audio model serves over the zero
encoder that ``Model.init_decode_state`` makes (half the cache's length
in frames), and a VLM's decode sees no patches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \
      --batch 4 --prompt-len 16 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-scout-17b-a16e --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import PRESETS
from repro_torch.models.model import Model


def generate(model: Model, params, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0, seed: int = 0,
             cache_len: int = 0) -> torch.Tensor:
    """prompts: (B, P) integers -> (B, P+gen) int32 tokens.

    The prompt is prefilled token by token through ``decode_step``
    (cache-exact), as the JAX package does.  Greedy sampling
    (``temperature <= 0``) is the argmax; temperature sampling draws
    from a ``torch.Generator`` on the prompts' device seeded with
    ``seed``, which does not replay ``jax.random.categorical``."""
    b, p_len = prompts.shape
    cache_len = cache_len or (p_len + gen)
    generator = torch.Generator(device=prompts.device).manual_seed(seed)
    prompts = prompts.to(torch.int32)
    with torch.no_grad():
        state = model.init_decode_state(params, b, cache_len,
                                        dtype=torch.float32)
        tokens = [prompts]
        logits = None
        for t in range(p_len):
            logits, state = model.decode_step(params, state,
                                              prompts[:, t:t + 1], t)
        cur = _sample(logits, temperature, generator)
        for t in range(gen):
            tokens.append(cur)
            logits, state = model.decode_step(params, state, cur, p_len + t)
            cur = _sample(logits, temperature, generator)
    return torch.cat(tokens, dim=1)


def _sample(logits, temperature, generator):
    if temperature <= 0:
        return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(
            torch.int32)
    p = torch.softmax(logits[:, -1, :] / temperature, dim=-1)
    return torch.multinomial(p, 1, generator=generator).to(torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny",
                    choices=list(PRESETS) + ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (PRESETS[args.arch] if args.arch in PRESETS
           else get_config(args.arch, smoke=args.smoke))
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
        device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, args.gen, args.temperature,
                   args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tput = args.batch * args.gen / dt
    print(f"[serve] arch={cfg.arch_id} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} "
          f"-> {tuple(out.shape)} in {dt:.2f}s ({tput_str(tput)})")
    print("[serve] sample row:", np.asarray(out[0].cpu())[:24].tolist())
    return out


def tput_str(tput: float) -> str:
    return f"{tput:,.1f} tok/s"


if __name__ == "__main__":
    main()
