"""The yardstick's operation and byte counts against hand-counted shapes."""
import pytest

from benchmark import harness, peaks


def test_packed_bytes_b1a():
    # B=64, N=208, F=500: bits 64*208*26 B, x and the output 64*208*500*4 B each
    assert peaks.packed_bytes(64, 208, 500) == 64 * 208 * 26 + 2 * 64 * 208 * 500 * 4
    assert round(peaks.packed_bytes(64, 208, 500) / 1e6, 1) == 53.6
    assert peaks.bound_s(peaks.packed_bytes(64, 208, 500)) == pytest.approx(16.0e-6, rel=2e-3)


def test_forward_flops_sage():
    cfg = harness.load_cell("sage3_flickr.train")["config"]
    n, e = 201.0, 1000.0
    macs = (n * 7 * 500 + (2 * n * 500 * 256 + e * 500) + 2 * (2 * n * 256 * 256 + e * 256)
            + 256 * 7)
    assert peaks.forward_flops(cfg, n, e) == pytest.approx(2 * macs)


def test_forward_flops_gat():
    cfg = harness.load_cell("gat5_products.train")["config"]
    n, e = 151.0, 2000.0
    f_in, layers = 194, []
    for _ in range(5):
        layers.append(2 * n * f_in * 512 + 2 * n * 512 + 4 * 22 * e + e * 512)
        f_in = 512
    macs = sum(layers) + n * 512 * 5 + 2 * 512 * 512 + 512 * 47
    assert peaks.forward_flops(cfg, n, e) == pytest.approx(2 * macs)


def test_gat_reader_bound():
    read = harness.reader(harness.load_cell("gat5_products.train")["metrics_dir"],
                          "gat_attention_roofline.train")
    cfg = harness.load_cell("gat5_products.train")["config"]
    # one forward launch of 31.0 us at its bound (B=128, N=152, H=4, dh=128)
    byts = 2 * 4 * 128 * 4 * 152 + 2 * 4 * 128 * 152 * 512 + 2 * 4 * 128 * 152 * 152
    ctx = {"trace": {"kernel_s": {"void gat_fwd_kernel<0>": byts / peaks.HBM_BYTES_PER_S}},
           "counters": {"gat_attention.launches": 1}, "traced": {"steps": 1},
           "subgraph": {"edges": 100.0, "nodes": 151.0}, "config": cfg, "per_rank": 128}
    assert read(ctx) == pytest.approx(100.0)
