"""The trace readers take the union of overlapping intervals, not their
sum."""
import pytest

from benchmark import harness, trace


class Ev:
    def __init__(self, name, s, d, dev=True):
        self._n, self._s, self._d, self._dev = name, s, d, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"


def test_union_not_sum():
    evs = [Ev("gemm", 0, 600), Ev("ncclAllReduce", 400, 400), Ev("relu", 900, 50),
           Ev("cudaGraphLaunch", 0, 10, dev=False), Ev("aten::copy_", 960, 30, dev=False)]
    s = trace.summarize(evs, (0, 1000))
    assert s["busy_s"] == pytest.approx(850e-9)          # [0, 800) and [900, 950)
    assert s["nccl_busy_s"] == pytest.approx(400e-9)
    assert sum(s["kernel_s"].values()) == pytest.approx(1050e-9)
    assert s["runtime_calls"] == 1
    assert dict(s["idle_gaps"])["aten::copy_"] == pytest.approx(50e-9)
    cell = harness.load_cell("sage3_flickr.train")
    ctx = {"trace": s}
    idle = harness.reader(cell["metrics_dir"], "device_idle_share.train")(ctx)
    assert idle == pytest.approx(15.0)


def test_reader_finds_nothing():
    cell = harness.load_cell("sage3_flickr.train")
    for m in cell["per_layer"]:
        assert harness.reader(cell["metrics_dir"], m["name"])({"rate": 1.0}) is None
