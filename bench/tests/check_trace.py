"""The profiler's raw events read into busy time, ranges and idle gaps,
with and without the events' ``activity_type`` (torch builds differ)."""
import pytest

from bench.tests import common  # noqa: F401
from bench.harness import trace


class Event:
    def __init__(self, name, device, start, dur, corr=0, tid=1, kind=None):
        self._v = (name, device, start, dur, corr, tid)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def events(with_kind):
    rows = [("bench.round", "CPU", 0, 1000, 0, "user_annotation"),
            ("selection", "CPU", 100, 400, 0, "user_annotation"),
            ("aten::mm", "CPU", 150, 100, 0, "cpu_op"),
            ("cudaLaunchKernel", "CPU", 200, 10, 7, "cuda_runtime"),
            ("cudaMemcpyAsync", "CPU", 600, 10, 8, "cuda_runtime"),
            ("void build_cost_walk<true>(float const*)", "CUDA", 300, 100, 7,
             "kernel"),
            ("selection", "CUDA", 300, 100, 0, "gpu_user_annotation"),
            ("Memcpy DtoH (Device -> Pinned)", "CUDA", 700, 50, 8,
             "gpu_memcpy")]
    return [Event(n, d, s, t, c, kind=k if with_kind else None)
            for n, d, s, t, c, k in rows]


@pytest.mark.parametrize("with_kind", [True, False])
def test_read_events(with_kind):
    p = trace.read_events(events(with_kind), ["selection"], 1e-6)
    assert p.busy_s == pytest.approx(150e-9)
    assert p.launches == 1
    (sel,) = p.ranges["selection"]
    assert sel.device_s == pytest.approx(100e-9)
    assert sel.by_kernel == {"build_cost_walk<true>": [1, pytest.approx(
        100e-9)]}
    # idle: [0, 300) with the host in selection > aten::mm at 150,
    # [400, 700) at 550 outside any op, [750, 1000) after
    assert sum(p.idle_by_host.values()) == pytest.approx(850e-9)
    assert p.idle_by_host["selection > aten::mm"] == pytest.approx(300e-9)
    assert p.breakdown()["device_ops"][0][0] == "build_cost_walk<true>"


def test_unlinked_kernel_inside_a_range_is_attributed():
    """A kernel whose launch the profiler missed (a library's own CUDA
    runtime) belongs to the range whose device span holds it."""
    rows = [("bench.round", "CPU", 0, 1000, 0, "user_annotation"),
            ("selection", "CPU", 100, 400, 0, "user_annotation"),
            ("cudaLaunchKernel", "CPU", 200, 10, 7, "cuda_runtime"),
            ("cudaLaunchKernel", "CPU", 300, 10, 9, "cuda_runtime"),
            ("aten_kernel_a", "CUDA", 300, 100, 7, "kernel"),
            ("void port_kernel(float*)", "CUDA", 410, 40, 99, "kernel"),
            ("aten_kernel_b", "CUDA", 460, 20, 9, "kernel"),
            ("void port_kernel(float*)", "CUDA", 800, 40, 98, "kernel")]
    ev = [Event(n, d, s, t, c, kind=k) for n, d, s, t, c, k in rows]
    p = trace.read_events(ev, ["selection"], 1e-6)
    (sel,) = p.ranges["selection"]
    assert sel.by_kernel["port_kernel"] == [1, pytest.approx(40e-9)]
    assert sel.device_s == pytest.approx(160e-9)
    assert p.unlinked == {"port_kernel": 2}


def test_ranges_whose_device_spans_overlap_share_no_operation():
    """Two ranges that do not nest on the host, whose operations'
    device spans interleave (the first range's second operation runs
    after the second range's): each operation counts once, under the
    range that launched it, and the two together never pass the busy
    time."""
    rows = [("bench.round", "CPU", 0, 2000, 0, "user_annotation"),
            ("local_sgd", "CPU", 100, 200, 0, "user_annotation"),
            ("coreset_group", "CPU", 400, 200, 0, "user_annotation"),
            ("cudaLaunchKernel", "CPU", 150, 10, 1, "cuda_runtime"),
            ("cudaLaunchKernel", "CPU", 250, 10, 2, "cuda_runtime"),
            ("cudaLaunchKernel", "CPU", 450, 10, 3, "cuda_runtime"),
            ("sgd_a", "CUDA", 500, 100, 1, "kernel"),
            ("select_b", "CUDA", 700, 100, 3, "kernel"),
            ("sgd_c", "CUDA", 1000, 100, 2, "kernel"),
            ("library_d", "CUDA", 1150, 50, 99, "kernel")]
    ev = [Event(n, d, s, t, c, kind=k) for n, d, s, t, c, k in rows]
    p = trace.read_events(ev, ["local_sgd", "coreset_group"], 1e-6)
    (sgd,), (core,) = p.ranges["local_sgd"], p.ranges["coreset_group"]
    assert sgd.device_s == pytest.approx(200e-9)
    assert set(sgd.by_kernel) == {"sgd_a", "sgd_c"}
    assert core.device_s == pytest.approx(100e-9)
    assert set(core.by_kernel) == {"select_b"}
    # library_d's launch lies after sgd_c's (250) and before its own start
    # (1150): it may lie outside both ranges, so it counts under neither
    assert p.range_device_s("local_sgd", "coreset_group") == \
        pytest.approx(300e-9)
    assert p.busy_s == pytest.approx(350e-9)


def test_short_name_drops_arguments_and_anonymous_namespace():
    assert trace.short_name("void (anonymous namespace)::from_feats_"
                            "distances<32, 4>(float const*, int)") == \
        "from_feats_distances<32, 4>"
    assert trace.short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD "
