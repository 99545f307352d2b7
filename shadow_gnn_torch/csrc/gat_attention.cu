// gat_attention for sm_90a: fused masked GAT attention over subgraph
// blocks, forward (B2) and backward (B3).
//
// Per subgraph b and head h (a_s, a_n [B, H, N]; v, out, g, dv [B, N, H, dh];
// adjn, adjs [B, N, N], all f32):
//   S[i,j]  = a_s[i] + a_n[j]                  on the structural edges adjs > 0
//   rm[i]   = max_j S[i,j]                     (0 for a row with no edge)
//   e[i,j]  = exp(S[i,j] - rm[i]) * adjn[i,j]  (0 off the structural edges)
//   D[i]    = max(sum_j e[i,j], 1e-10)
//   out[i]  = (sum_j e[i,j] v[j]) / D[i]                          forward
//   P = e / D;  r[i] = g[i].out[i];  ds[i,j] = P[i,j] (g[i].v[j] - r[i])
//   da_s[i] = sum_j ds[i,j];  da_n[j] = sum_i ds[i,j];  dv[j] = sum_i P[i,j] g[i]
//                                                                  backward
//
// Replaces the TPU kernels of shadow_gnn_tpu/ops/pallas_gat.py:
// gat_attention_hm -> _fwd_kernel (the forward) and _bwd_hm -> _bwd_kernel
// (the backward), at their default f32 level.
//
// What bounds it: a call must read the two adjacency blocks, the score
// terms and v once (and, backward, out and g) and write out (backward:
// da_s, da_n, dv): about 104 MB forward and 184 MB backward at B=128,
// N=152, H=4, dh=128, 31 / 55 us at 3.35 TB/s.  The work that the data
// needs is a few multiply-adds of dh per structural edge and head, far
// below the card's f32 rate, so both directions are bound by bytes.  The
// TPU kernel's dense [N, N] x [N, dh] MXU products are not carried over:
// the PPR blocks hold a few edges per row.
//
// Layout: v, out, g and dv are read in the node-major [B, N, H, dh] layout
// the linears produce: each (node, head) row is dh contiguous floats, so
// the head-major copies the TPU kernel needed are not made.
//
// Design (simple first, no wgmma/TMA):
// * rows kernels (forward, and the backward's row pass): one block per (b,
//   tile of ROWS output rows).  One warp per row walks its adjs row 32
//   entries per ballot into an ascending list of structural columns (u16)
//   and their adjn values in shared memory; the list serves every head.
//   Then one warp per (row, head): the row max over the list (exact, as
//   the TPU's), e and D by lanes over the list, then lanes over dh gather
//   the listed rows of v (coalesced: dh contiguous floats) and accumulate
//   in registers, in list order.  The backward's row pass computes r, D
//   and rm, and da_s by one warp dot product g[i].v[j] per listed j.
// * columns kernel (the backward's column sums): one block per (b, tile of
//   32 columns).  Warps read rows of adjs 32 columns at a time (coalesced)
//   into a bitmap per column, then one warp per (column, head) walks its
//   column's set bits in ascending i, recomputes e from the row pass's rm
//   and D, and sums dv and da_n in registers: no atomics, deterministic.
// Rows are read by whole warps and no [N, N] tile is held: shared memory
// grows with N (about 80 bytes per row), so N up to ~2900 fits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChunks = 8;  // dh <= 32 * kMaxChunks: dh/32 values per lane

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// butterfly sum: every lane ends with the same value
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ size_t vrow(int b, int n, int h, int dh, int i, int hh) {
  return (((size_t)b * n + i) * h + hh) * dh;
}

// Warp-collective walk of row i of a subgraph's adjs block: the structural
// columns (adjs > 0), ascending, into lst and their adjn values into w.
// Returns the count.
__device__ __forceinline__ int row_list(const float* __restrict__ adjs_row,
                                        const float* __restrict__ adjn_row, int n,
                                        uint16_t* lst, float* w) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;
  for (int c = 0; c < n; c += 32) {
    const int j = c + lane;
    const bool s = j < n && adjs_row[j] > 0.0f;
    const unsigned ms = __ballot_sync(kFull, s);
    if (s) {
      const int k = cnt + __popc(ms & below);
      lst[k] = (uint16_t)j;
      w[k] = adjn_row[j];
    }
    cnt += __popc(ms);
  }
  return cnt;
}

// The scores of row i, head hh over its list: e[k] into pe, returns
// (rm, D) with rm = 0 for an empty row and D clipped at 1e-10.
__device__ __forceinline__ float2 row_scores(float as, const float* __restrict__ an,
                                             const uint16_t* lst, const float* w,
                                             int deg, float* pe) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int k = lane; k < deg; k += 32) m = fmaxf(m, as + an[lst[k]]);
  m = warp_max(m);
  if (!isfinite(m)) m = 0.0f;
  float dsum = 0.0f;
  for (int k = lane; k < deg; k += 32) {
    const float e = expf((as + an[lst[k]]) - m) * w[k];
    pe[k] = e;
    dsum += e;
  }
  dsum = warp_sum(dsum);
  __syncwarp();
  return make_float2(m, fmaxf(dsum, 1e-10f));
}

// shared memory of the rows kernels:
//   wv[rows*n] f32 | pe[warps*n] f32 | cnt[rows] i32 | nbr[rows*n] u16
struct RowSmem {
  float* wv;
  float* pe;
  int* cnt;
  uint16_t* nbr;
  __device__ RowSmem(unsigned char* p, int n, int rows, int warps) {
    wv = reinterpret_cast<float*>(p);
    pe = wv + (size_t)rows * n;
    cnt = reinterpret_cast<int*>(pe + (size_t)warps * n);
    nbr = reinterpret_cast<uint16_t*>(cnt + rows);
  }
};

// kBwd = false: the forward (writes out).  kBwd = true: the backward's row
// pass (reads out and g; writes da_s and the row statistics rm, D, r).
template <bool kBwd>
__global__ void gat_rows_kernel(const float* __restrict__ a_s,
                                const float* __restrict__ a_n,
                                const float* __restrict__ v,
                                const float* __restrict__ adjn,
                                const float* __restrict__ adjs,
                                const float* __restrict__ out_in,
                                const float* __restrict__ g,
                                float* __restrict__ out, float* __restrict__ das,
                                float* __restrict__ stats, int bsz, int n, int h,
                                int dh, int rows_per_block, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  RowSmem sm(smem, n, rows_per_block, nwarps);
  const float* adjs_b = adjs + (size_t)b * n * n;
  const float* adjn_b = adjn + (size_t)b * n * n;

  for (int r = warp; r < rows; r += nwarps) {
    const size_t off = (size_t)(row0 + r) * n;
    const int c = row_list(adjs_b + off, adjn_b + off, n, sm.nbr + (size_t)r * n,
                           sm.wv + (size_t)r * n);
    if (lane == 0) sm.cnt[r] = c;
  }
  __syncthreads();

  float* pe = sm.pe + (size_t)warp * n;
  for (int t = warp; t < rows * h; t += nwarps) {
    const int r = t / h;
    const int hh = t - r * h;
    const int i = row0 + r;
    const int deg = sm.cnt[r];
    const uint16_t* lst = sm.nbr + (size_t)r * n;
    const size_t bh = ((size_t)b * h + hh) * n;
    const float2 st = row_scores(a_s[bh + i], a_n + bh, lst, sm.wv + (size_t)r * n,
                                 deg, pe);
    const float den = st.y;
    if (!kBwd) {
      float acc[kMaxChunks];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.0f;
      for (int k = 0; k < deg; ++k) {
        const float e = pe[k];
        if (e == 0.0f) continue;           // dropped edge: adds nothing
        const float* vr = v + vrow(b, n, h, dh, lst[k], hh);
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int d = c * 32 + lane;
          if (d < dh) acc[c] += e * vr[d];
        }
      }
      float* orow = out + vrow(b, n, h, dh, i, hh);
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int d = c * 32 + lane;
        if (d < dh) orow[d] = acc[c] / den;
      }
    } else {
      const float* grow = g + vrow(b, n, h, dh, i, hh);
      const float* orow = out_in + vrow(b, n, h, dh, i, hh);
      float gi[kMaxChunks];
      float ri = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int d = c * 32 + lane;
        gi[c] = d < dh ? grow[d] : 0.0f;
        if (d < dh) ri += gi[c] * orow[d];
      }
      ri = warp_sum(ri);
      float ds_sum = 0.0f;
      for (int k = 0; k < deg; ++k) {
        const float e = pe[k];
        if (e == 0.0f) continue;           // P = 0: ds = 0
        const float p = e / den;
        const float* vr = v + vrow(b, n, h, dh, lst[k], hh);
        float gv = 0.0f;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int d = c * 32 + lane;
          if (d < dh) gv += gi[c] * vr[d];
        }
        gv = warp_sum(gv);
        ds_sum += p * (gv - ri);
      }
      if (lane == 0) {
        const size_t plane = (size_t)bsz * h * n;
        das[bh + i] = ds_sum;
        stats[bh + i] = st.x;              // rm
        stats[plane + bh + i] = den;       // D
        stats[2 * plane + bh + i] = ri;    // r
      }
    }
    __syncwarp();                          // pe is reused by the next task
  }
}

// The backward's column sums: da_n and dv, one block per (b, tile of 32
// columns).  shared memory: colbits[32 * words] u32, words = ceil(n / 32).
__global__ void gat_cols_kernel(const float* __restrict__ a_s,
                                const float* __restrict__ a_n,
                                const float* __restrict__ v,
                                const float* __restrict__ adjn,
                                const float* __restrict__ adjs,
                                const float* __restrict__ g,
                                const float* __restrict__ stats,
                                float* __restrict__ dan, float* __restrict__ dv,
                                int bsz, int n, int h, int dh, int col_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* colbits = reinterpret_cast<uint32_t*>(smem);
  const int b = blockIdx.x / col_tiles;
  const int j0 = (blockIdx.x % col_tiles) * 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int words = (n + 31) / 32;
  const float* adjs_b = adjs + (size_t)b * n * n;
  const float* adjn_b = adjn + (size_t)b * n * n;
  const int jl = j0 + lane;

  // bit (i % 32) of colbits[c * words + i / 32]: adjs[i, j0 + c] > 0
  for (int q = warp; q < words; q += nwarps) {
    uint32_t word = 0;
    const int i1 = min(32, n - q * 32);
    for (int ii = 0; ii < i1; ++ii) {
      const int i = q * 32 + ii;
      if (jl < n && adjs_b[(size_t)i * n + jl] > 0.0f) word |= 1u << ii;
    }
    colbits[lane * words + q] = word;
  }
  __syncthreads();

  const size_t plane = (size_t)bsz * h * n;
  for (int t = warp; t < 32 * h; t += nwarps) {
    const int c = t / h;
    const int hh = t - c * h;
    const int j = j0 + c;
    if (j >= n) continue;                  // uniform across the warp
    const size_t bh = ((size_t)b * h + hh) * n;
    const float an = a_n[bh + j];
    const float* vr = v + vrow(b, n, h, dh, j, hh);
    float vj[kMaxChunks], acc[kMaxChunks];
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int d = k * 32 + lane;
      vj[k] = d < dh ? vr[d] : 0.0f;
      acc[k] = 0.0f;
    }
    float dan_sum = 0.0f;
    for (int q = 0; q < words; ++q) {
      uint32_t word = colbits[c * words + q];
      while (word) {
        const int i = q * 32 + __ffs(word) - 1;
        word &= word - 1u;
        // e exactly as the row pass formed it
        const float e = expf((a_s[bh + i] + an) - stats[bh + i])
                        * adjn_b[(size_t)i * n + j];
        if (e == 0.0f) continue;
        const float p = e / stats[plane + bh + i];
        const float* grow = g + vrow(b, n, h, dh, i, hh);
        float gi[kMaxChunks];
        float gv = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxChunks; ++k) {
          const int d = k * 32 + lane;
          gi[k] = d < dh ? grow[d] : 0.0f;
          gv += gi[k] * vj[k];
        }
        gv = warp_sum(gv);
#pragma unroll
        for (int k = 0; k < kMaxChunks; ++k) acc[k] += p * gi[k];
        dan_sum += p * (gv - stats[2 * plane + bh + i]);
      }
    }
    float* dvr = dv + vrow(b, n, h, dh, j, hh);
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int d = k * 32 + lane;
      if (d < dh) dvr[d] = acc[k];
    }
    if (lane == 0) dan[bh + j] = dan_sum;
  }
}

template <typename K>
int set_smem(K kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

}  // namespace

extern "C" {

// Grids, blocks and dynamic shared memory come from the caller
// (shadow_gnn_torch/ops/gat.py:launch_dims).  Each launches on `stream`
// and returns cudaGetLastError() after its launches (0 = launched).

int gat_attention_forward(const void* a_s, const void* a_n, const void* v,
                          const void* adjn, const void* adjs, void* out, int bsz,
                          int n, int h, int dh, int rows_per_block, int tiles,
                          int grid, int threads, int smem_bytes, void* stream) {
  int e = set_smem(gat_rows_kernel<false>, smem_bytes);
  if (e != 0) return e;
  gat_rows_kernel<false><<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(a_s), static_cast<const float*>(a_n),
      static_cast<const float*>(v), static_cast<const float*>(adjn),
      static_cast<const float*>(adjs), nullptr, nullptr, static_cast<float*>(out),
      nullptr, nullptr, bsz, n, h, dh, rows_per_block, tiles);
  return (int)cudaGetLastError();
}

// The row pass (da_s and the row statistics into `stats` [3, B, H, N]),
// then the column pass (da_n, dv), in stream order.
int gat_attention_backward(const void* a_s, const void* a_n, const void* v,
                           const void* adjn, const void* adjs, const void* out,
                           const void* g, void* das, void* dan, void* dv,
                           void* stats, int bsz, int n, int h, int dh,
                           int rows_per_block, int tiles, int grid, int threads,
                           int smem_bytes, int col_tiles, int col_grid,
                           int col_smem_bytes, void* stream) {
  int e = set_smem(gat_rows_kernel<true>, smem_bytes);
  if (e != 0) return e;
  e = set_smem(gat_cols_kernel, col_smem_bytes);
  if (e != 0) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  gat_rows_kernel<true><<<grid, threads, smem_bytes, s>>>(
      static_cast<const float*>(a_s), static_cast<const float*>(a_n),
      static_cast<const float*>(v), static_cast<const float*>(adjn),
      static_cast<const float*>(adjs), static_cast<const float*>(out),
      static_cast<const float*>(g), nullptr, static_cast<float*>(das),
      static_cast<float*>(stats), bsz, n, h, dh, rows_per_block, tiles);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  gat_cols_kernel<<<col_grid, threads, col_smem_bytes, s>>>(
      static_cast<const float*>(a_s), static_cast<const float*>(a_n),
      static_cast<const float*>(v), static_cast<const float*>(adjn),
      static_cast<const float*>(adjs), static_cast<const float*>(g),
      static_cast<const float*>(stats), static_cast<float*>(dan),
      static_cast<float*>(dv), bsz, n, h, dh, col_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
