// packed_spmm for sm_90a: fused bit-unpack + dropedge + normalise +
// aggregate, and its transpose (the backward).
//
//   forward     out[b] = W[b] @ x[b]
//   transposed  dx[b]  = W[b]^T @ g[b]
//   W[b] = norm(unpack(bits[b]) * keep(seed, b))
//   bits [B, N, BYTES] uint8 (BYTES = ceil(N/8)), x / g [B, N, F] f32 -> [B, N, F] f32
//
// Replaces the TPU kernel shadow_gnn_tpu/ops/pallas_packed.py:_kernel,
// called from packed_spmm -> _call with transpose=False (the forward) and
// from packed_spmm._bwd -> _call with transpose=True (the backward), in
// both of its modes: f32, and bf16=True (the normalised entries of W and
// x / g rounded to bf16, products accumulated in f32; pallas_packed.py
// :90-94, the --matmul_precision bfloat16 trade).
//
// Bit layout (sampling/cache.py, "tiled"): column j of row i is bit
// (j / BYTES) of byte (j % BYTES).  Columns >= N are never read.
//
// Dropedge: keep(seed, b, i, j) is the counter hash of
// shadow_gnn_torch/ops/normalize.py (mix32 below), so the plain PyTorch
// version draws the same mask bit for bit and the backward regenerates
// the forward's mask from the seed.  Survival of entry (i, j): A(i,j) and
// keep(i,j); for sym also A(j,i) and keep(j,i) (s * s^T).  Degrees count
// the survivors, clipped at 1.  Row scales: none 1; rw 1/deg_i; sym
// deg_i^-1/2 on both sides; gin deg0_i / deg_i (deg0 = undropped degree).
//
// What bounds it: one call must read bits and x once and write out once,
// B*(N*BYTES + 2*N*F*4) bytes, in either direction: 53.6 MB at B=64,
// N=208, F=500, which is 0.016 ms at 3.35 TB/s.  The gather-add form does
// about nnz*F multiply-adds (12.4 M there), far below the card's f32
// rate, so it is bound by memory bytes.  The TPU kernel's dense MXU dot
// (2*B*N^2*F flops) is not carried over: the cached PPR blocks hold about
// 2 edges per row (0.9% dense at N=208), so a tensor-core tile product
// would do ~200x the useful work and, in f32 mode, need x split into
// bf16 parts; the gather is bytes-bound at the same 0.016 ms.
//
// Design.  The output lines (the forward's rows of W, the transposed
// kernel's columns) of one subgraph are split over one thread-block
// cluster of C <= 8 CTAs of 128 threads (ops/packed.py:launch_dims; 8
// CTAs of 26 lines at N=208): rank r owns the `tile` lines
// [r*tile, (r+1)*tile).  Each CTA
//   1. scans the bit block (the forward its own rows, the transposed
//      kernel every row), every thread holding 16 byte loads in flight.  A
//      table of the wanted bits of each byte column (the transposed
//      kernel's own columns) masks each byte, so only wanted entries are
//      visited; rows and byte columns are stepped, not divided.  Each
//      surviving entry sets one bit of a bitmap in shared memory laid out
//      in the direction of the sum (line k: the ascending indices m it
//      sums over).  Each structural entry belongs to one line, so its
//      dropedge hash is evaluated once per cluster (sym: keep(i,j) and
//      keep(j,i), twice).  The same pass counts the survivors and raw
//      entries of each row: the forward owns whole rows, the transposed
//      kernel adds its columns' share of every row;
//   2. where the sums read scales of rows it does not own (sym, and every
//      norm but none of the transposed kernel), exchanges them through
//      distributed shared memory after cluster.sync(): the forward copies
//      the scales it lacks from their owners, the transposed kernel adds
//      the C shares of each row's counts (map_shared_rank);
//   3. gathers: one warp per (output line, group of up to 4 chunks of 128
//      features), each lane loading a float4 per chunk (512 B per warp
//      instruction), the loads of 2 listed neighbours (8 float4 a lane)
//      issued before any is used.  Sums run in f32 in ascending order of
//      the neighbour index: deterministic, no atomics.  F % 4 != 0 (rows
//      not 16-byte aligned) takes the scalar variant (kVec false): 4
//      strided floats a lane.
// 128 threads at most 80 registers each let an SM hold 6 CTAs, so one
// CTA's scan overlaps the others' gathers.  Where B * C CTAs would not
// fill the card (B=8 at N=208), the features are split over `fsplit`
// clusters per subgraph, each redoing steps 1-2: the structure work is
// done fsplit times per call (1 at B >= 33 and N=208), never once per
// tile.  The forward takes a tile larger than its bitmap room in sub-tiles
// of `sub` lines, each scanned and gathered in turn; for sym that scans
// the tile twice (counts, then the bitmaps), so its hashes run twice.
// The transposed kernel needs its tile in one bitmap (the wrapper raises
// beyond that N).
//
// bf16 mode (kB): JAX rounds each normalised entry W[i,j] to bf16, so the
// factored sums above stay exact only where W's rows are constant: rw and
// gin store the rounded scale bf16(rscale[i]) (every entry of row i is
// that value); sym's entries bf16(r_i * r_j) are rounded one by one, with
// nothing factored out.  x / g are rounded per load with
// __float2bfloat16_rn; a product of two bf16 values is exact in f32, and
// the sums run in f32.  The bytes read stay f32.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum Norm { kNone = 0, kRw = 1, kSym = 2, kGin = 3 };
constexpr int kThreads = 128;  // ops/packed.py:THREADS
constexpr int kMinBlocks = 6;  // CTAs an SM holds: at most 80 registers a thread
constexpr int kChunk = 128;    // features of a chunk: one float4 per lane
constexpr int kGroup = 4;      // chunks of one warp task
constexpr int kUnroll = 2;     // neighbours whose loads are issued together
constexpr int kBatch = 16;     // bytes of the bit block a thread loads at once
constexpr int kMaxCluster = 8;  // ops/packed.py:MAX_CLUSTER

// the lowbias32 finaliser; ops/normalize.py:mix32 is its plain twin
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

struct Drop {
  bool on;
  uint32_t key;     // mix32(mix32(seed) + b)
  uint32_t thresh;  // uint32(int(p * (2^32 - 1)))
  __device__ __forceinline__ bool keep(int i, int j) const {
    return mix32(key ^ (((uint32_t)i << 16) | (uint32_t)j)) > thresh;
  }
};

__device__ __forceinline__ bool bit(const uint8_t* blk, int nbytes, int i, int j) {
  return (blk[i * nbytes + j % nbytes] >> (j / nbytes)) & 1;
}

// whether the structural entry (i, j) survives the drop
__device__ __forceinline__ bool survives(const uint8_t* blk, int nbytes, int i,
                                         int j, bool sym, const Drop& d) {
  return !d.on || (d.keep(i, j) && (!sym || (bit(blk, nbytes, j, i) && d.keep(j, i))));
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// an operand of the product: rounded to bf16 in bf16 mode
template <bool kB>
__device__ __forceinline__ float operand(float v) {
  return kB ? bf16r(v) : v;
}

__device__ __forceinline__ float row_scale(int norm, int deg, int deg0) {
  const float d = fmaxf((float)deg, 1.0f);
  if (norm == kRw) return 1.0f / d;
  if (norm == kSym) return rsqrtf(d);
  if (norm == kGin) return (float)deg0 / d;
  return 1.0f;
}

// the scale kept in shared memory, from a row's packed count
// (survivors | raw << 16): rounded in bf16 mode, except sym's r_i, which
// enters every entry r_i * r_j before the rounding
template <bool kB>
__device__ __forceinline__ float kept_scale(int norm, uint32_t count) {
  const float s = row_scale(norm, (int)(count & 0xFFFFu), (int)(count >> 16));
  return kB && norm != kSym ? bf16r(s) : s;
}

__device__ __forceinline__ void clear(uint32_t* p, int count) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) p[k] = 0u;
}

// The bits of byte c of row i that this pass wants: bit t is column
// c + t * nbytes; the forward wants the columns < n, the transposed kernel
// its lines [lo, hi).  One entry per byte column, in shared memory.
__device__ __forceinline__ uint32_t byte_mask(int c, int nbytes, int lo, int hi) {
  uint32_t m = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = c + t * nbytes;
    if (j >= lo && j < hi) m |= 1u << t;
  }
  return m;
}

// Before a scan of the lines [lo, hi): their bitmap cleared (`count`
// words) and the wanted bits of each byte column.
template <bool kT>
__device__ __forceinline__ void prepare(uint32_t* sb, int count, uint8_t* want,
                                        int nbytes, int lo, int hi, int n) {
  clear(sb, count);
  for (int c = threadIdx.x; c < nbytes; c += blockDim.x)
    want[c] = (uint8_t)byte_mask(c, nbytes, kT ? lo : 0, kT ? hi : n);
}

// The wanted entries v != 0 of byte c of row i: each surviving entry
// (i, j) sets bit m of line k in sb (line k - lo, `words` words a line;
// forward k = i, m = j; transposed k = j, m = i); when cnt is not null,
// (survivors | raw << 16) of the byte is added to cnt[i].
template <bool kT>
__device__ __forceinline__ void visit(const uint8_t* __restrict__ blk, int nbytes,
                                      int lo, int words, bool sym, const Drop& d,
                                      uint32_t* sb, uint32_t* cnt, int i, int c,
                                      uint32_t v) {
  uint32_t kept = 0;
  const uint32_t raw = __popc(v);
  for (; v != 0u; v &= v - 1u) {
    const int j = c + (__ffs(v) - 1) * nbytes;
    if (!survives(blk, nbytes, i, j, sym, d)) continue;
    ++kept;
    const int k = kT ? j : i, m = kT ? i : j;
    atomicOr(&sb[(k - lo) * words + (m >> 5)], 1u << (m & 31));
  }
  if (cnt != nullptr) atomicAdd(&cnt[i], kept | raw << 16);
}

// Step 1 for the lines [lo, hi): every byte of their rows (the forward's
// rows lo..hi-1, every row for the transposed kernel), kBatch loads in
// flight a thread, masked by `want` (byte_mask of each byte column); the
// row and byte column of each byte follow from the thread's first by
// steps of blockDim.x bytes, so no byte needs a division.  sb must be 0.
template <bool kT>
__device__ void scan(const uint8_t* __restrict__ blk, int n, int nbytes, int lo,
                     int hi, int words, bool sym, const Drop& d, uint32_t* sb,
                     uint32_t* cnt, const uint8_t* want) {
  const int end = (kT ? n : hi) * nbytes;
  const int step = blockDim.x;
  const int di = step / nbytes, dc = step - di * nbytes;
  int q = (kT ? 0 : lo * nbytes) + threadIdx.x;
  int i = q / nbytes, c = q - i * nbytes;
  for (; q < end; q += kBatch * step) {
    uint32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int qu = q + u * step;
      v[u] = qu < end ? blk[qu] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (v[u] != 0u) {
        const uint32_t m = v[u] & want[c];
        if (m != 0u) visit<kT>(blk, nbytes, lo, words, sym, d, sb, cnt, i, c, m);
      }
      c += dc;
      i += di;
      if (c >= nbytes) {
        c -= nbytes;
        ++i;
      }
    }
  }
}

// 4 features of a row from column `col`: kVec, the float4 at col (col =
// chunk start + 4 * lane); else col, col+32, col+64, col+96 (col = chunk
// start + lane).  Columns >= f read as 0.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int col, int f) {
  if (kVec) {
    return col < f ? __ldg(reinterpret_cast<const float4*>(row + col))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return make_float4(col < f ? __ldg(row + col) : 0.0f,
                     col + 32 < f ? __ldg(row + col + 32) : 0.0f,
                     col + 64 < f ? __ldg(row + col + 64) : 0.0f,
                     col + 96 < f ? __ldg(row + col + 96) : 0.0f);
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int col, int f, float4 v) {
  if (kVec) {
    if (col < f) *reinterpret_cast<float4*>(row + col) = v;
    return;
  }
  if (col < f) row[col] = v.x;
  if (col + 32 < f) row[col + 32] = v.y;
  if (col + 64 < f) row[col + 64] = v.z;
  if (col + 96 < f) row[col + 96] = v.w;
}

template <bool kB>
__device__ __forceinline__ void fma4(float4& acc, float w, float4 v) {
  acc.x = fmaf(w, operand<kB>(v.x), acc.x);
  acc.y = fmaf(w, operand<kB>(v.y), acc.y);
  acc.z = fmaf(w, operand<kB>(v.z), acc.z);
  acc.w = fmaf(w, operand<kB>(v.w), acc.w);
}

// Step 3 for the lines [lo, hi) and the chunks [ch_lo, ch_hi):
//   forward:    out[i] = rscale[i] * sum_j (sym ? rscale[j] : 1) * x[j]
//   transposed: out[j] = (sym ? rscale[j] : 1) * sum_i rscale[i] * g[i]
//   bf16 sym:   out[k] = sum_m bf16(rscale[k] * rscale[m]) * bf16(x[m])
// (an unweighted term is fmaf(1, x, acc): the plain sum, rounded once)
template <bool kT, bool kB, bool kVec>
__device__ void gather(const float* __restrict__ x_b, float* __restrict__ out_b,
                       const uint32_t* sb, const float* scale, int lo, int hi,
                       int words, int f, int norm, int ch_lo, int ch_hi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool sym = norm == kSym;
  const bool pair = kB && sym;
  const bool weighted = pair || (kT ? norm != kNone : sym);
  const int groups = (ch_hi - ch_lo + kGroup - 1) / kGroup;
  const int tasks = (hi - lo) * groups;
  const int lane_col = kVec ? 4 * lane : lane;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int t = warp; t < tasks; t += nwarps) {
    const int k = lo + t / groups;
    const int ch0 = ch_lo + (t % groups) * kGroup;
    const int nch = min(kGroup, ch_hi - ch0);
    const uint32_t* line = sb + (k - lo) * words;
    const float rk = pair ? scale[k] : 0.0f;
    const float s = pair ? 1.0f : kT ? (sym ? scale[k] : 1.0f) : scale[k];
    float4 acc[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) acc[q] = zero;
    int w = 0;
    uint32_t cur = line[0];
    for (;;) {
      int m[kUnroll];  // the next listed neighbours, ascending; -1 past the end
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        while (cur == 0u && ++w < words) cur = line[w];
        m[u] = cur != 0u ? (w << 5) + __ffs(cur) - 1 : -1;
        cur &= cur - 1u;
      }
      if (m[0] < 0) break;
      float4 v[kUnroll][kGroup];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          v[u][q] = m[u] >= 0 && q < nch
                        ? load4<kVec>(x_b + (size_t)m[u] * f, (ch0 + q) * kChunk + lane_col, f)
                        : zero;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (m[u] < 0) break;
        const float wt = !weighted ? 1.0f : pair ? bf16r(rk * scale[m[u]]) : scale[m[u]];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) fma4<kB>(acc[q], wt, v[u][q]);
      }
    }
    float* orow = out_b + (size_t)k * f;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (q < nch) {
        store4<kVec>(orow, (ch0 + q) * kChunk + lane_col, f,
                     make_float4(acc[q].x * s, acc[q].y * s, acc[q].z * s, acc[q].w * s));
      }
    }
  }
}

// shared memory: cnt[n] u32 (survivors | raw << 16) | scale[n] f32 |
//                sb[sub * words] u32 (the bitmap of `sub` lines) |
//                want[nbytes] u8 (byte_mask of each byte column)
// grid: B * fsplit clusters of C CTAs; cluster (b, fc) covers the chunks
// [fc * per, (fc + 1) * per) of subgraph b
template <bool kT, bool kB, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    packed_spmm_kernel(const uint8_t* __restrict__ bits, const float* __restrict__ x,
                       float* __restrict__ out, int n, int nbytes, int f, int norm,
                       int drop_on, uint32_t seed, uint32_t thresh, int tile,
                       int sub, int fsplit, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / csize;
  const int b = cid / fsplit;
  const int ch_lo = (cid % fsplit) * per;
  const int ch_hi = min((f + kChunk - 1) / kChunk, ch_lo + per);
  const int words = (n + 31) >> 5;
  const int t0 = min(n, rank * tile);
  const int t1 = min(n, t0 + tile);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem);
  float* scale = reinterpret_cast<float*>(cnt + n);
  uint32_t* sb = reinterpret_cast<uint32_t*>(scale + n);
  uint8_t* want = reinterpret_cast<uint8_t*>(sb + sub * words);
  const uint8_t* blk = bits + (size_t)b * n * nbytes;
  const float* x_b = x + (size_t)b * n * f;
  float* out_b = out + (size_t)b * n * f;
  const Drop d{drop_on != 0, mix32(mix32(seed) + (uint32_t)b), thresh};
  const bool sym = norm == kSym;

  if (kT ? norm == kNone : !sym) {
    // the sums read only the line's own scale: each sub-tile on its own
    for (int lo = t0; lo < t1; lo += sub) {
      const int hi = min(t1, lo + sub);
      prepare<kT>(sb, (hi - lo) * words, want, nbytes, lo, hi, n);
      if (!kT) clear(cnt + lo, hi - lo);
      __syncthreads();
      scan<kT>(blk, n, nbytes, lo, hi, words, sym, d, sb, kT ? nullptr : cnt, want);
      __syncthreads();
      if (!kT) {
        for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
          scale[i] = kept_scale<kB>(norm, cnt[i]);
      }
      __syncthreads();
      gather<kT, kB, kVec>(x_b, out_b, sb, scale, lo, hi, words, f, norm, ch_lo, ch_hi);
      __syncthreads();
    }
    return;
  }

  // step 1 over the whole tile: counts (the forward's own rows complete,
  // the transposed kernel's share of every row) and the bitmap of the
  // last sub-tile (the only one, in the transposed kernel)
  if (kT) clear(cnt, n);
  for (int lo = t0; lo < t1; lo += sub) {
    const int hi = min(t1, lo + sub);
    prepare<kT>(sb, (hi - lo) * words, want, nbytes, lo, hi, n);
    if (!kT) clear(cnt + lo, hi - lo);
    __syncthreads();
    scan<kT>(blk, n, nbytes, lo, hi, words, sym, d, sb, cnt, want);
    __syncthreads();
  }
  // step 2: the scales of every row.  The forward owns its rows' counts
  // and reads the other rows' scales from their owners; the transposed
  // kernel adds every rank's share of each row's counts.
  if (!kT) {
    for (int i = t0 + threadIdx.x; i < t1; i += blockDim.x)
      scale[i] = kept_scale<kB>(norm, cnt[i]);
  }
  cluster.sync();  // every rank's counts and scales are in
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (kT) {
      uint32_t total = 0;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < csize) total += *cluster.map_shared_rank(cnt + i, r);
      scale[i] = kept_scale<kB>(norm, total);
    } else if (i < t0 || i >= t1) {
      scale[i] = *cluster.map_shared_rank(scale + i, i / tile);
    }
  }
  // arrive once this CTA reads no other's shared memory, wait before
  // leaving: no CTA leaves while another may still read its memory
  cluster.barrier_arrive();
  __syncthreads();
  // step 3; a forward tile of several sub-tiles scans each one again
  for (int lo = t0; lo < t1; lo += sub) {
    const int hi = min(t1, lo + sub);
    if (sub < t1 - t0) {
      __syncthreads();
      prepare<kT>(sb, (hi - lo) * words, want, nbytes, lo, hi, n);
      __syncthreads();
      scan<kT>(blk, n, nbytes, lo, hi, words, sym, d, sb, nullptr, want);
      __syncthreads();
    }
    gather<kT, kB, kVec>(x_b, out_b, sb, scale, lo, hi, words, f, norm, ch_lo, ch_hi);
  }
  cluster.barrier_wait();
}

template <bool kT, bool kB, bool kVec>
int launch_mode(const void* bits, const void* x, void* out, int n, int nbytes,
                int f, int norm, int drop_on, uint32_t seed, uint32_t thresh,
                int cluster, int tile, int sub, int fsplit, int per, int grid,
                int threads, int smem_bytes, void* stream) {
  auto kernel = packed_spmm_kernel<kT, kB, kVec>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint8_t*>(bits), static_cast<const float*>(x),
      static_cast<float*>(out), n, nbytes, f, norm, drop_on, seed, thresh, tile, sub,
      fsplit, per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool kT>
int launch(const void* bits, const void* x, void* out, int n, int nbytes, int f,
           int norm, int drop_on, uint32_t seed, uint32_t thresh, int bf16, int vec,
           int cluster, int tile, int sub, int fsplit, int per, int grid,
           int threads, int smem_bytes, void* stream) {
#define PACKED_SPMM_LAUNCH(KB, KV)                                                  \
  launch_mode<kT, KB, KV>(bits, x, out, n, nbytes, f, norm, drop_on, seed, thresh, \
                          cluster, tile, sub, fsplit, per, grid, threads,          \
                          smem_bytes, stream)
  if (bf16) return vec ? PACKED_SPMM_LAUNCH(true, true) : PACKED_SPMM_LAUNCH(true, false);
  return vec ? PACKED_SPMM_LAUNCH(false, true) : PACKED_SPMM_LAUNCH(false, false);
#undef PACKED_SPMM_LAUNCH
}

}  // namespace

extern "C" {

// Both launch on `stream`, in clusters of `cluster` CTAs; grid, block,
// dynamic shared memory and the tiling come from the caller
// (shadow_gnn_torch/ops/packed.py:launch_dims); bf16 != 0 selects the
// bf16 mode, vec != 0 the float4 loads (F % 4 == 0, x 16-byte aligned).
// Each returns the launch's CUDA error (0 = launched).
int packed_spmm_forward(const void* bits, const void* x, void* out, int n,
                        int nbytes, int f, int norm, int drop_on, uint32_t seed,
                        uint32_t thresh, int bf16, int vec, int cluster, int tile,
                        int sub, int fsplit, int per, int grid, int threads,
                        int smem_bytes, void* stream) {
  return launch<false>(bits, x, out, n, nbytes, f, norm, drop_on, seed, thresh, bf16,
                       vec, cluster, tile, sub, fsplit, per, grid, threads,
                       smem_bytes, stream);
}

int packed_spmm_transposed(const void* bits, const void* g, void* out, int n,
                           int nbytes, int f, int norm, int drop_on, uint32_t seed,
                           uint32_t thresh, int bf16, int vec, int cluster,
                           int tile, int sub, int fsplit, int per, int grid,
                           int threads, int smem_bytes, void* stream) {
  return launch<true>(bits, g, out, n, nbytes, f, norm, drop_on, seed, thresh, bf16,
                      vec, cluster, tile, sub, fsplit, per, grid, threads,
                      smem_bytes, stream);
}

}  // extern "C"
