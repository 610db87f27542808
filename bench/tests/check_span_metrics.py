"""The readers of the program's spans on hand-built span records: what
each sums and divides, and no number where its spans are missing or
carry no stream time (a program without them, or a run on the CPU)."""
import pytest

from bench.tests.common import spec


class Ctx:
    def __init__(self, spans, rounds):
        self.spans = spans
        self.walls = [1.0] * rounds


def span(name, dur=0.0, dev_s=None, **attrs):
    return {"kind": "span", "name": name, "dur": dur, "dev_s": dev_s,
            "attrs": attrs}


def read(metric, spans, rounds=2):
    return spec.load_metric(metric).read(Ctx(spans, rounds))


def test_sgd_step_ms_is_host_time_over_the_steps_stamped():
    spans = [span("sgd_steps", 0.30, 9.0, steps=50, n_clients=4),
             span("coreset_epochs", 0.02, 9.0, steps=4, n_clients=4),
             span("sgd_steps", 0.06, 9.0, steps=10, n_clients=2),
             span("local_sgd", 5.0, 9.0),
             {"kind": "event", "name": "round", "data": {}}]
    assert read("sgd_step_ms", spans) == pytest.approx(1e3 * 0.38 / 64)


@pytest.mark.parametrize("metric,names", [
    ("kmedoids_build_ms", ("kmedoids_build",)),
    ("kmedoids_swap_ms", ("kmedoids_swap",)),
    ("lm_init_ms", ("lm_init",)),
    ("lm_select_ms", ("grad_features", "selection"))])
def test_stream_time_readers_sum_dev_s_over_the_rounds(metric, names):
    spans = [span(n, dur=7.0, dev_s=0.25 * (i + 1), sweeps=3)
             for i, n in enumerate(names * 2)]
    spans += [span("coreset_group", dur=9.0, dev_s=9.0),
              span("kmedoids_build" if "lm" in metric else "lm_init",
                   dev_s=9.0)]
    want = 1e3 * sum(0.25 * (i + 1) for i in range(2 * len(names))) / 3
    assert read(metric, spans, rounds=3) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["sgd_step_ms", "kmedoids_build_ms",
                                    "kmedoids_swap_ms", "lm_init_ms",
                                    "lm_select_ms"])
def test_readers_give_nothing_without_their_spans(metric):
    other = [span("local_sgd", 1.0, 1.0), span("cohort_build", 1.0)]
    assert read(metric, other) is None
    assert read(metric, []) is None
    if metric != "sgd_step_ms":      # spans, but none timed on a stream
        names = {"kmedoids_build_ms": "kmedoids_build",
                 "kmedoids_swap_ms": "kmedoids_swap",
                 "lm_init_ms": "lm_init", "lm_select_ms": "selection"}
        assert read(metric, [span(names[metric], 1.0, None)]) is None
