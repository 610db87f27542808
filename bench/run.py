#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it is started on:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the cell's inputs and weights from the seed, the port's kernels
from the build cache inside the checkout, the warm and checked rounds),
then whole rounds until ``--seconds`` have passed, each ending in
``torch.cuda.synchronize()``; then, with ``--trace 1``, one more round
under ``torch.profiler``; then the reference judges what the set-up's
rounds produced.  The last line of standard output is the result as one
JSON object; the last lines of standard error are the numbers compared,
each beside its limit.  Exits non-zero, with no result, where the card
or the port is missing or where a module of JAX or of the JAX package
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROFILE_TRIES = 3       # the profiler on this card can miss a session
# substrings of the names of the port's CUDA kernels (kernels/csrc/)
PORT_KERNELS = ("pairwise_l2", "build_cost", "delta_sweep", "from_feats",
                "flash_attention", "rmsnorm")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Context:
    """What a per-layer metric reader (``bench/metrics/<name>.py``) may
    read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run(args, device=None, config=None) -> int:
    """One run.  ``device`` and ``config`` are for the CPU tests of the
    harness (``bench/tests``), which drive a run at a small size without
    the card; the command line always runs on the card."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import env, spec, trace

    env.set_cache_dirs(ROOT)
    bench_json = spec.benchmark(ROOT)
    cell = spec.load_cell(args.workload)
    config = config or spec.load_config(cell["config"])
    wanted = spec.cell_metrics(args.workload, bench_json)

    import torch
    if device is None:
        problem = env.card_problem(torch, int(cell["chips"]))
        if problem:
            log(f"no result: {problem}")
            return 2
        device = torch.device("cuda", 0)
        log(env.card_line(torch))
    device = torch.device(device)
    on_card = device.type == "cuda"
    env.fp32_exact(torch)
    seed = args.seed % (1 << 63)
    drv = spec.load_driver(cell["entry"]).Driver(cell, config, seed, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup()
    if on_card:
        torch.cuda.synchronize(device)

    from repro_torch.obs import InMemorySink, Recorder, use_recorder
    sink = InMemorySink()
    recorder = Recorder([sink]) if args.trace else None
    t_window = time.perf_counter()
    setup_s = t_window - T_START
    walls = []
    while True:
        t0 = time.perf_counter()
        if recorder is None:
            drv.run_round()
        else:
            with use_recorder(recorder):
                drv.run_round()
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        if t1 - t_window >= args.seconds:
            break
    window_s = t1 - t_window
    round_s = window_s / len(walls)
    log(f"setup_s {setup_s!r}; window {window_s!r} s, {len(walls)} rounds, "
        f"round walls {walls}")

    profiled, launches = None, {}
    if args.trace:
        from repro_torch.kernels import ops

        hooks = getattr(drv, "profiling", contextlib.nullcontext)

        def one_round():
            with use_recorder(Recorder([], annotate=True)), hooks():
                drv.run_round()

        for _ in range(PROFILE_TRIES):
            before = dict(ops.LAUNCHES)
            profiled = trace.profile_round(one_round, drv.range_names,
                                           torch, on_card)
            launches = {k: v - before.get(k, 0)
                        for k, v in ops.LAUNCHES.items()}
            if profiled.busy_s > 0 or not on_card:
                break
        log(f"profiled round: wall {profiled.wall_s!r} s, busy "
            f"{profiled.busy_s!r} s (device operations' summed time "
            f"{sum(v[1] for v in profiled.ops_by_name.values())!r} s), "
            f"{profiled.launches} kernels; "
            f"activity kinds {profiled.kinds}; port launches {launches}; "
            f"device operations whose launch the profiler missed "
            f"{profiled.unlinked}")
        log("device time under the program's ranges: " + "; ".join(
            f"{n} {profiled.range_device_s(n)!r} s"
            for n in drv.range_names if profiled.ranges.get(n)))
        log("port kernels in the profiled round: " + "; ".join(
            f"{n} x{v[0]} {v[1]!r} s" for n, v in profiled.ops_by_name.items()
            if any(k in n for k in PORT_KERNELS)))

    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = env.forbidden_loaded()
    if found:
        log(f"no result: modules of JAX or of the JAX package loaded: "
            f"{found}")
        return 3
    log(f"memory_peak_bytes {peak}")

    ctx = Context(cell=cell, config=config, driver=drv, torch=torch,
                  round_s=round_s, walls=walls, spans=sink.records,
                  profiled=profiled, launches=launches,
                  flops_per_round=drv.flops_per_round(), **drv.context())
    drv.close_program()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = drv.check(cell["limits"])
    log(f"reference took {time.perf_counter() - t_ref!r} s")
    correct = all(n.ok for n in numbers)

    metrics = {}
    if args.trace:
        for m in wanted["per_layer"]:
            value = spec.load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        own = {"round_s": round_s, "setup_s": setup_s}
        for m in wanted["end_to_end"]:
            value = (own[m["name"]] if m["name"] in own
                     else spec.load_metric(m["name"]).read(ctx))
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(walls), "failed": 0,
              "metrics": metrics, "device": device_info}
    if profiled is not None:
        device_info["busy_s"] = profiled.busy_s
        device_info["window_s"] = profiled.wall_s
        result["breakdown"] = profiled.breakdown()
    found = env.forbidden_loaded()
    if found:
        log(f"no result: modules of JAX or of the JAX package loaded: "
            f"{found}")
        return 3
    result["checks"] = {n.name: {"value": n.value, "limit": n.limit}
                        for n in numbers}
    for n in numbers:
        log(n.line())
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    try:
        return run(args)
    except Exception:       # the run's boundary: report, print no result
        log("no result:\n" + traceback.format_exc())
        return 1


if __name__ == "__main__":
    sys.exit(main())
