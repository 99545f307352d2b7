"""The program's spans in a traced slice (``span_trace.py``): idle gaps
split by the CUDA call of the operation that ends each, host-bound time
put down to the innermost span, the host's time a step less its blocked
time, and the three readers."""
import pytest

from benchmark import harness, span_trace, trace

READERS = ("host_bound_idle_share.train", "epoch_boundary_ms.train", "host_step_us.train")


class Ev:
    def __init__(self, name, s, d, dev=False, corr=0):
        self._n, self._s, self._d, self._dev, self._c = name, s, d, dev, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def correlation_id(self):
        return self._c


def span(name, s, e):
    return Ev(name, s, e - s)


def call(name, s, e, corr):
    return Ev(name, s, e - s, corr=corr)


def op(name, s, e, corr):
    return Ev(name, s, e - s, dev=True, corr=corr)


WINDOW = (0, 1100)
EVENTS = [
    span("sgnn.epoch", 0, 1000), span("sgnn.epoch.prepare", 0, 100),
    span("sgnn.epoch.steps", 100, 900), span("sgnn.step", 100, 500),
    span("sgnn.graphs.replay", 120, 200), span("sgnn.step", 500, 900),
    span("sgnn.epoch.readback", 900, 950), span("sgnn.epoch.metrics", 950, 1000),
    # a copy whose call returned after the device went idle at 0
    call("cudaMemcpyAsync", 10, 20, 1), op("Memcpy HtoD", 30, 60, 1),
    # a graph: three kernels of one launch, two gaps inside it
    call("cudaGraphLaunch", 150, 190, 2), op("gemm", 180, 250, 2),
    op("relu", 260, 300, 2), op("add", 310, 400, 2),
    call("cudaLaunchKernel", 520, 530, 3), op("packed_spmm_kernel", 600, 850, 3),
    op("ncclKernel", 870, 880, 99),             # its call is not in the trace
    Ev("Command Buffer Full", 700, 60), call("cudaStreamSynchronize", 880, 895, 4),
    Ev("aten::copy_", 20, 5),
]


def test_gaps_split_by_the_call_that_launched_the_next_operation():
    p = span_trace.summarize(EVENTS, WINDOW)
    idle = p["idle"]
    # [0, 30), [60, 180), [400, 600), [880, 1100); [250, 260), [300, 310); [850, 870)
    assert idle["host_bound_s"] == pytest.approx(570e-9)
    assert idle["device_side_s"] == pytest.approx(20e-9)
    assert idle["unmatched_s"] == pytest.approx(20e-9)
    t = trace.summarize(EVENTS, WINDOW)
    assert sum(idle.values()) == pytest.approx(t["window_s"] - t["busy_s"], abs=1e-15)


def test_host_bound_time_goes_to_the_innermost_span():
    by = span_trace.summarize(EVENTS, WINDOW)["host_bound_by_span"]
    want = {"sgnn.epoch.prepare": 70, "sgnn.step": 240, "sgnn.graphs.replay": 60,
            "sgnn.epoch.readback": 50, "sgnn.epoch.metrics": 50,
            span_trace.OUTSIDE: 100}
    assert by == pytest.approx({k: v * 1e-9 for k, v in want.items()})


def test_span_counts_and_self_time():
    spans = span_trace.summarize(EVENTS, WINDOW)["spans"]
    assert spans["sgnn.step"]["count"] == 2
    assert spans["sgnn.step"]["host_s"] == pytest.approx(800e-9)
    assert spans["sgnn.step"]["self_s"] == pytest.approx(720e-9)
    assert spans["sgnn.epoch"]["self_s"] == pytest.approx(0.0)
    assert spans["sgnn.epoch.steps"]["self_s"] == pytest.approx(0.0)


def test_step_host_time_leaves_out_blocked_time():
    st = span_trace.summarize(EVENTS, WINDOW)["step_host_s"]
    # the steps hold 40 + 10 + 15 ns of CUDA calls (the graph's launch, a
    # kernel's, a sync) and the second 60 ns of a full launch queue
    assert st == pytest.approx({"count": 2, "host_s": 675e-9, "raw_s": 800e-9,
                                "calls_s": 125e-9})


def test_readers():
    cell = harness.load_cell("sage3_flickr.train")
    t = trace.summarize(EVENTS, WINDOW)
    t["program"] = span_trace.summarize(EVENTS, WINDOW)
    got = {m: harness.reader(cell["metrics_dir"], m)({"trace": t}) for m in READERS}
    assert got == pytest.approx({"host_bound_idle_share.train": 100 * 570 / 1100,
                                 "epoch_boundary_ms.train": 170e-6,
                                 "host_step_us.train": 0.3375})


def test_boundary_is_per_epoch():
    second = [Ev(e.name(), e.start_ns() + 1100, e.duration_ns(),
                 "CUDA" in e.device_type(), e.correlation_id() + 100) for e in EVENTS]
    t = trace.summarize(EVENTS + second, (0, 2200))
    t["program"] = span_trace.summarize(EVENTS + second, (0, 2200))
    assert t["program"]["spans"]["sgnn.epoch"]["count"] == 2
    cell = harness.load_cell("sage3_flickr.train")
    # each epoch's boundary as before (the gap between them is split
    # among the first's last spans, the time outside both, the second's
    # first)
    got = harness.reader(cell["metrics_dir"], "epoch_boundary_ms.train")({"trace": t})
    assert got == pytest.approx(170e-6)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing(name):
    cell = harness.load_cell("sage3_flickr.train")
    read = harness.reader(cell["metrics_dir"], name)
    t = trace.summarize(EVENTS, WINDOW)
    assert read({"rate": 1.0}) is None
    assert read({"trace": t}) is None                      # no program key
    t["program"] = span_trace.summarize(
        [e for e in EVENTS if e.name() != "sgnn.epoch"], WINDOW)
    assert read({"trace": t}) is None                      # no epoch span
    t["program"] = span_trace.summarize(EVENTS + [op("x", 1050, 1060, 98)], WINDOW)
    assert read({"trace": t}) is None                      # unmatched above 5%
