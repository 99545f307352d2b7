// packed_spmm forward: fused bit-unpack + normalise + aggregate for sm_90a.
//
//   out[b] = norm(unpack(bits[b])) @ x[b]
//   bits [B, N, BYTES] uint8 (BYTES = ceil(N/8)), x [B, N, F] f32 -> [B, N, F] f32
//
// Replaces the TPU kernel shadow_gnn_tpu/ops/pallas_packed.py:_kernel
// (called from packed_spmm -> _call, transpose=False, dropedge 0).
//
// Bit layout (sampling/cache.py, "tiled"): column j of row i is bit
// (j / BYTES) of byte (j % BYTES).  Bits of columns >= N are never read,
// and degrees mask them off, so padding bits read as 0.
//
// Norms, degrees clipped at 1:  none: raw 0/1 product;  rw: row i scaled
// by 1/deg_i;  sym: entry (i, j) scaled by deg_i^-1/2 deg_j^-1/2 (every
// row's degree is needed, so the block keeps all N degrees in shared
// memory);  gin at dropedge 0: the raw product (deg0/degd = 1 on every
// non-empty row).
//
// What bounds it: one call must read bits and x once and write out once,
// B*(N*BYTES + 2*N*F*4) bytes; the gather-add form does nnz*F adds, far
// below the card's f32 rate, so it is bound by memory bytes.  The TPU
// kernel's lane-repeat unpack and dense MXU dot (2*B*N^2*F flops) are not
// carried over: the cached PPR blocks hold about 2 edges per row (~1%
// dense at N=208), so a dense product would do ~200x the necessary work.
//
// Design (simple first, no wgmma/TMA): one block per (b, tile of
// `rows_per_block` rows).  One warp per tile row decodes the row into an
// ascending neighbour list in shared memory with ballots (deterministic
// summation order).  Then the block's threads stride over F, so each
// neighbour row x[b, j, :] is read coalesced, and accumulate in f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Norm { kNone = 0, kRw = 1, kSym = 2, kGin = 3 };

// number of set bits of one packed row among columns j < n
__device__ __forceinline__ int row_degree(const uint8_t* row, int n, int nbytes) {
  int d = 0;
  for (int byte = 0; byte < nbytes; ++byte) {
    const int nvalid = (n - byte + nbytes - 1) / nbytes;  // bits s: s*nbytes+byte < n
    const unsigned mask = nvalid >= 8 ? 0xffu : ((1u << nvalid) - 1u);
    d += __popc(row[byte] & mask);
  }
  return d;
}

// shared memory: dinv[n] f32 | scale[rows] f32 | cnt[rows] i32 | nbr[rows*n] u16
__global__ void packed_spmm_fwd_kernel(const uint8_t* __restrict__ bits,
                                       const float* __restrict__ x,
                                       float* __restrict__ out, int n,
                                       int nbytes, int f, int rows_per_block,
                                       int tiles, int norm) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dinv = reinterpret_cast<float*>(smem);
  float* scale = dinv + n;
  int* cnt = reinterpret_cast<int*>(scale + rows_per_block);
  uint16_t* nbr = reinterpret_cast<uint16_t*>(cnt + rows_per_block);

  const int b = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  const uint8_t* bits_b = bits + (size_t)b * n * nbytes;
  const float* x_b = x + (size_t)b * n * f;
  float* out_b = out + (size_t)b * n * f;

  if (norm == kSym) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float d = (float)row_degree(bits_b + (size_t)j * nbytes, n, nbytes);
      dinv[j] = rsqrtf(fmaxf(d, 1.0f));
    }
  }

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
    const uint8_t* row = bits_b + (size_t)(row0 + r) * nbytes;
    int base = 0;
    for (int c = 0; c < n; c += 32) {
      const int j = c + lane;
      const bool set = j < n && ((row[j % nbytes] >> (j / nbytes)) & 1);
      const unsigned m = __ballot_sync(0xffffffffu, set);
      if (set) nbr[r * n + base + __popc(m & below)] = (uint16_t)j;
      base += __popc(m);
    }
    if (lane == 0) cnt[r] = base;
  }
  __syncthreads();

  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float s = 1.0f;
    if (norm == kRw) s = 1.0f / fmaxf((float)cnt[r], 1.0f);
    else if (norm == kSym) s = dinv[row0 + r];
    scale[r] = s;
  }
  __syncthreads();

  for (int r = 0; r < rows; ++r) {
    const int deg = cnt[r];
    const uint16_t* lst = nbr + r * n;
    const float s = scale[r];
    float* out_row = out_b + (size_t)(row0 + r) * f;
    for (int col = threadIdx.x; col < f; col += blockDim.x) {
      float acc = 0.0f;
      if (norm == kSym) {
#pragma unroll 4
        for (int k = 0; k < deg; ++k) {
          const int j = lst[k];
          acc += dinv[j] * x_b[(size_t)j * f + col];
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < deg; ++k) acc += x_b[(size_t)lst[k] * f + col];
      }
      out_row[col] = acc * s;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; grid, block and dynamic shared memory come from
// the caller (shadow_gnn_torch/ops/packed.py:launch_dims).  Returns
// cudaGetLastError() after the launch (0 = launched).
int packed_spmm_forward(const void* bits, const void* x, void* out, int n,
                        int nbytes, int f, int norm, int rows_per_block,
                        int tiles, int grid, int threads, int smem_bytes,
                        void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_spmm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  packed_spmm_fwd_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(bits), static_cast<const float*>(x),
      static_cast<float*>(out), n, nbytes, f, rows_per_block, tiles, norm);
  return (int)cudaGetLastError();
}

}  // extern "C"
