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
// N=208, F=500, which is 0.016 ms at 3.35 TB/s.  The gather-add form does about nnz*F multiply-adds, far below the
// card's f32 rate, so it is bound by memory bytes.  The TPU kernel's
// dense MXU dot (2*B*N^2*F flops) is not carried over: the cached PPR
// blocks hold about 2 edges per row (~1% dense at N=208).
//
// Design (simple first, no wgmma/TMA): one block per (b, tile of
// `rows_per_block` output rows).  One warp per output row walks its line
// of the bit block (the forward a row, the transposed kernel a column)
// 32 entries per ballot into an ascending list of survivors in shared
// memory.  Then the block's threads stride over F, so each listed row of
// x / g is read coalesced, and accumulate in f32 in list order: no
// atomics, and the result is deterministic.  A column walk reads one bit
// per row, so the transposed kernel first copies the subgraph's whole bit
// block (5.4 KB at N=208) into shared memory.  Row scales that the sum
// needs beyond the tile (sym, and every norm of the transposed kernel,
// whose column sums run over all rows) are computed by one pass of warps
// over all N rows of the block.
//
// bf16 mode (kB): JAX rounds each normalised entry W[i,j] to bf16, so the
// factored sums above stay exact only where W's rows are constant: rw and
// gin store the rounded scale bf16(rscale[i]) (every entry of row i is
// that value); sym's entries bf16(r_i * r_j) are rounded one by one, with
// nothing factored out.  x / g are rounded per load with
// __float2bfloat16_rn; a product of two bf16 values is exact in f32, and
// the sums run in f32.  The bytes read stay f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Norm { kNone = 0, kRw = 1, kSym = 2, kGin = 3 };

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

// Warp-collective walk of line k of the block: row k (col=false) or
// column k (col=true), in ascending order of the other index m.  Writes
// the surviving m into lst (when not null); returns (survivors, entries
// set before the drop).
__device__ __forceinline__ int2 walk(const uint8_t* blk, int n, int nbytes, int k,
                                     bool col, bool sym, const Drop& d,
                                     uint16_t* lst) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int kept = 0, raw = 0;
  for (int c = 0; c < n; c += 32) {
    const int m = c + lane;
    const int i = col ? m : k;
    const int j = col ? k : m;
    const bool a = m < n && bit(blk, nbytes, i, j);
    const bool s = a && (!d.on || (d.keep(i, j) &&
                                   (!sym || (bit(blk, nbytes, j, i) && d.keep(j, i)))));
    const unsigned ms = __ballot_sync(0xffffffffu, s);
    raw += __popc(__ballot_sync(0xffffffffu, a));
    if (lst != nullptr && s) lst[kept + __popc(ms & below)] = (uint16_t)m;
    kept += __popc(ms);
  }
  return make_int2(kept, raw);
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

// the scale kept in shared memory: rounded in bf16 mode, except sym's
// r_i, which enters every entry r_i * r_j before the rounding
template <bool kB>
__device__ __forceinline__ float kept_scale(int norm, int deg, int deg0) {
  const float s = row_scale(norm, deg, deg0);
  return kB && norm != kSym ? bf16r(s) : s;
}

// shared memory: [kT: bit block, rounded up to 16 B] | rscale[n] f32 |
//                cnt[rows] i32 | nbr[rows*n] u16
template <bool kT, bool kB>
__global__ void packed_spmm_kernel(const uint8_t* __restrict__ bits,
                                   const float* __restrict__ x,
                                   float* __restrict__ out, int n, int nbytes,
                                   int f, int norm, int drop_on, uint32_t seed,
                                   uint32_t thresh, int rows_per_block, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  const uint8_t* blk = bits + (size_t)b * n * nbytes;
  unsigned char* p = smem;
  if (kT) {
    const int nb = n * nbytes;
    for (int k = threadIdx.x; k < nb; k += blockDim.x) smem[k] = blk[k];
    blk = smem;
    p += (nb + 15) / 16 * 16;
  }
  float* rscale = reinterpret_cast<float*>(p);
  int* cnt = reinterpret_cast<int*>(rscale + n);
  uint16_t* nbr = reinterpret_cast<uint16_t*>(cnt + rows_per_block);
  const Drop d{drop_on != 0, mix32(mix32(seed) + (uint32_t)b), thresh};
  const bool sym = norm == kSym;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (kT) __syncthreads();

  // scales of every row, where the sum reads rows outside the tile
  const bool all_rows = (kT || sym) && norm != kNone;
  if (all_rows) {
    for (int i = warp; i < n; i += nwarps) {
      const int2 c = walk(blk, n, nbytes, i, false, sym, d, nullptr);
      if (lane == 0) rscale[i] = kept_scale<kB>(norm, c.x, c.y);
    }
  }
  for (int r = warp; r < rows; r += nwarps) {
    const int2 c = walk(blk, n, nbytes, row0 + r, kT, sym, d, nbr + r * n);
    if (lane == 0) {
      cnt[r] = c.x;
      if (!kT && !sym) rscale[row0 + r] = kept_scale<kB>(norm, c.x, c.y);
    }
  }
  __syncthreads();

  // forward:    out[i] = rscale[i] * sum_j (sym ? rscale[j] : 1) * x[j]
  // transposed: out[j] = (sym ? rscale[j] : 1) * sum_i rscale[i] * g[i]
  // bf16 sym:   out[k] = sum_m bf16(rscale[k] * rscale[m]) * bf16(x[m])
  const bool pair = kB && sym;
  const bool weighted = pair || (kT ? norm != kNone : sym);
  const float* x_b = x + (size_t)b * n * f;
  float* out_b = out + (size_t)b * n * f;
  for (int r = 0; r < rows; ++r) {
    const int deg = cnt[r];
    const uint16_t* lst = nbr + r * n;
    const int row = row0 + r;
    const float rrow = pair ? rscale[row] : 0.0f;
    const float s = pair ? 1.0f : kT ? (sym ? rscale[row] : 1.0f) : rscale[row];
    float* out_row = out_b + (size_t)row * f;
    for (int col = threadIdx.x; col < f; col += blockDim.x) {
      float acc = 0.0f;
      if (weighted) {
#pragma unroll 4
        for (int k = 0; k < deg; ++k) {
          const int m = lst[k];
          const float w = pair ? bf16r(rrow * rscale[m]) : rscale[m];
          acc += w * operand<kB>(x_b[(size_t)m * f + col]);
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < deg; ++k) acc += operand<kB>(x_b[(size_t)lst[k] * f + col]);
      }
      out_row[col] = acc * s;
    }
  }
}

template <bool kT, bool kB>
int launch_mode(const void* bits, const void* x, void* out, int n, int nbytes,
                int f, int norm, int drop_on, uint32_t seed, uint32_t thresh,
                int rows_per_block, int tiles, int grid, int threads,
                int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_spmm_kernel<kT, kB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  packed_spmm_kernel<kT, kB><<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(bits), static_cast<const float*>(x),
      static_cast<float*>(out), n, nbytes, f, norm, drop_on, seed, thresh,
      rows_per_block, tiles);
  return (int)cudaGetLastError();
}

template <bool kT>
int launch(const void* bits, const void* x, void* out, int n, int nbytes, int f,
           int norm, int drop_on, uint32_t seed, uint32_t thresh, int bf16,
           int rows_per_block, int tiles, int grid, int threads, int smem_bytes,
           void* stream) {
  return bf16 ? launch_mode<kT, true>(bits, x, out, n, nbytes, f, norm, drop_on,
                                      seed, thresh, rows_per_block, tiles, grid,
                                      threads, smem_bytes, stream)
              : launch_mode<kT, false>(bits, x, out, n, nbytes, f, norm, drop_on,
                                       seed, thresh, rows_per_block, tiles, grid,
                                       threads, smem_bytes, stream);
}

}  // namespace

extern "C" {

// Both launch on `stream`; grid, block and dynamic shared memory come
// from the caller (shadow_gnn_torch/ops/packed.py:launch_dims); bf16 != 0
// selects the bf16 mode.  Each returns cudaGetLastError() after the
// launch (0 = launched).
int packed_spmm_forward(const void* bits, const void* x, void* out, int n,
                        int nbytes, int f, int norm, int drop_on, uint32_t seed,
                        uint32_t thresh, int bf16, int rows_per_block, int tiles,
                        int grid, int threads, int smem_bytes, void* stream) {
  return launch<false>(bits, x, out, n, nbytes, f, norm, drop_on, seed, thresh,
                       bf16, rows_per_block, tiles, grid, threads, smem_bytes,
                       stream);
}

int packed_spmm_transposed(const void* bits, const void* g, void* out, int n,
                           int nbytes, int f, int norm, int drop_on,
                           uint32_t seed, uint32_t thresh, int bf16,
                           int rows_per_block, int tiles, int grid, int threads,
                           int smem_bytes, void* stream) {
  return launch<true>(bits, g, out, n, nbytes, f, norm, drop_on, seed, thresh,
                      bf16, rows_per_block, tiles, grid, threads, smem_bytes,
                      stream);
}

}  // extern "C"
