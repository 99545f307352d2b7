#!/usr/bin/env python3
"""B1a/B1b/B1c with the dropedge seed read from device memory (the
package's ``csrc/packed_spmm.cu``) against an earlier source of the same
kernels that takes the seed by value (a ``uint32_t`` argument), timed in
turns on one card.

Run from the repository root on a machine with one CUDA GPU, with the
earlier source written out first, e.g. the parent of the change:

    git show 5045282:shadow_gnn_torch/csrc/packed_spmm.cu > tmp/packed_parent.cu
    python3 tools/packed_seed_ab.py tmp/packed_parent.cu

Both are built with the package's nvcc flags.  On the flagship's cached
TRAIN bits (the flickr-scale synthetic graph, B=64, N=208, F=500,
dropedge 0.05 under one seed) each direction and norm (rw, sym, gin,
and rw in the bf16 mode) is called once through each library (the
outputs must be equal bit for bit), then timed as CUDA-graph replays of
20 calls (``chip_smoke._time_ms``), by-value, pointer, pointer,
by-value, three rounds; the median and the range of each are printed.
"""
import ctypes
import os
import subprocess
import sys
import tempfile


def main(parent_src):
    import torch
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.ops import build, packed
    if not torch.cuda.is_available():
        print("packed_seed_ab: CUDA is not available", file=sys.stderr)
        return 1
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libpacked_by_value.so")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, parent_src],
                       check=True, stdout=subprocess.DEVNULL)
        libs = {"by value": ctypes.CDLL(so), "pointer": build.load("packed_spmm")}
        tr = cs._flagship_trainer(cs._flickr_graph())
        tr._ensure_caches(TRAIN)
        bits = tr.caches[TRAIN][0].adj_bits[:64].contiguous()
        b, n, nbytes = bits.shape
        f, p, seed = 500, 0.05, 12345
        x = torch.randn(b, n, f, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
        seed_d = torch.full((), seed, dtype=torch.int64, device="cuda")

        def caller(name, transpose, norm, bf16):
            fn = (libs[name].packed_spmm_transposed if transpose
                  else libs[name].packed_spmm_forward)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                           + [ctypes.c_uint32 if name == "by value"
                              else ctypes.c_void_p, ctypes.c_uint32]
                           + [ctypes.c_int] * 10 + [ctypes.c_void_p])
            d = packed.launch_dims(b, n, f, transpose)
            out = torch.empty_like(x)
            arg = ctypes.c_uint32(seed) if name == "by value" else seed_d.data_ptr()

            def call():
                rc = fn(bits.data_ptr(), x.data_ptr(), out.data_ptr(), n, nbytes, f,
                        packed._NORM_CODE[norm], 1, arg,
                        ctypes.c_uint32(packed.drop_threshold(p)), int(bf16), 1,
                        d.cluster, d.tile, d.sub, d.fsplit, d.per, d.grid, d.threads,
                        d.smem, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            return call, out

        for norm, bf16 in (("rw", False), ("sym", False), ("gin", False), ("rw", True)):
            for transpose in (False, True):
                calls = {k: caller(k, transpose, norm, bf16) for k in libs}
                for call, _ in calls.values():
                    call()
                torch.cuda.synchronize()
                if not torch.equal(calls["by value"][1], calls["pointer"][1]):
                    raise AssertionError("the two sources' outputs differ")
                times = {k: [] for k in libs}
                for _ in range(3):
                    for k in ("by value", "pointer", "pointer", "by value"):
                        times[k].append(cs._time_ms(calls[k][0]))
                print(f"[seed a/b] {'B1b' if transpose else 'B1a'} {norm}"
                      f"{' bf16' if bf16 else ''} B={b} N={n} F={f} p={p}: " + ", ".join(
                          f"{k} {cs._median(v):.4f} ms ({min(v):.4f}-{max(v):.4f})"
                          for k, v in times.items()) + "; outputs equal bit for bit")
    print(cs._card())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
