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
// (the backward), at each of their three levels (template kLevel):
//   0  f32 (B2, B3);
//   1  bf16 (B2b, B3b): the operands of the products are rounded to bf16 and
//      accumulated in f32: e and v in the forward; g and v in g.v, and P and
//      g in dv, in the backward.  D, r = g.out and ds = P (g.v - r) stay f32
//      with the unrounded P, as in _fwd_kernel / _bwd_kernel (:93-124);
//   2  bf16 + bf16_scores: also e = bf16(exp(bf16(s - rm))) * adjn (_scores,
//      :75-78), D the f32 sum of those rounded e.
// s - rm is formed in f32 before its rounding; exp is the expf of level 0.
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
// the linears produce: each (node, head) row is dh contiguous floats, read
// and written as float4 (dh % 4 == 0); a lane owns 4 contiguous features of
// each 128.
//
// Design (ops/gat.py:launch_dims holds the launch arithmetic).  One CTA of
// 512 threads per (subgraph, head), in b-major order, launched in clusters
// of two CTAs of one subgraph (cudaLaunchKernelEx).  Every phase below is
// a pass of the whole block; the dependent chains are short and many are
// in flight, which is what a kernel that moves a few hundred KB per CTA at
// a few edges per row needs.
// * The structure: the two CTAs of a cluster each read half of the adjs
//   block, flat over the block with float4 loads (eight in flight a
//   thread), into a bitmap of the structural entries in shared memory,
//   and copy each other's half through distributed shared memory.  So the
//   block comes from HBM once and from L2 once more for the other head
//   pair; adjn is read only at the structural entries, once each.
// * Staging: the head's slice of v (forward) or g (backward) is copied
//   into shared memory with bulk copies (TMA, cp.async.bulk, a row each,
//   issued by the whole block) that complete on an mbarrier, while the
//   edges are numbered and their scores computed.
// * Edge slots: the edges are numbered from the bitmap by a block scan of
//   its row counts (forward: row order) or, backward, of the counts of a
//   column bitmap transposed from it in 32 x 32 tiles with ballots
//   (column order: (i, j) is slot colstart[j] + the bits of column j
//   below i).  Each slot holds its row and column (u16) and one f32: e,
//   then (backward) ds.  A thread per slot computes e = exp(S - rm) * adjn
//   once, with every adjn read in flight together; a thread per row sums
//   D in ascending j.  The slots live in shared memory unless a subgraph
//   has more edges than fit (edge_cap), then in the wrapper's scratch
//   buffer, N^2 slots per CTA.
// * forward (B2): a warp per row gathers the rows of the staged v slice
//   listed in its slots, as float4 in ascending j, and writes out as
//   float4 (a CTA owns dh / split features, split > 1 only where v's
//   slice would not fit two CTAs an SM).
// * backward (B3), one launch: r = g[i].out[i] a warp per row (out read
//   once, four rows in flight); then a half-warp per column (8 features of
//   each 128 a lane, two columns a warp, the next pair's v loaded ahead)
//   walks its slots in ascending i: P = e / D and g.v once per kept edge
//   from the staged g, ds = P (g.v - r) back into the slot, da_n and dv
//   summed in registers; then a thread per row sums its ds in ascending j
//   into da_s.  exp is taken once per edge, g.v once per kept edge, every
//   sum in a fixed order: deterministic, no atomics.  Where g's slice does
//   not fit beside the structure (N * dh * 4 bytes; e.g. N=408 dh=200) it
//   is gathered from global memory instead.
// Limits: dh <= 256, dh % 4 == 0, and N <= 907 (the backward's row and
// column bitmaps in one block's shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

// butterfly sum: every lane ends with the same value
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// an operand of a product: rounded to bf16 at levels 1 and 2
template <int kLevel>
__device__ __forceinline__ float operand(float v) {
  return kLevel > 0 ? bf16r(v) : v;
}

template <int kLevel>
__device__ __forceinline__ float4 operand4(float4 v) {
  return make_float4(operand<kLevel>(v.x), operand<kLevel>(v.y),
                     operand<kLevel>(v.z), operand<kLevel>(v.w));
}

// e before the adjn factor, from x = s - rm
template <int kLevel>
__device__ __forceinline__ float edge_exp(float x) {
  return kLevel == 2 ? bf16r(expf(bf16r(x))) : expf(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x += s * x.x;
  acc.y += s * x.y;
  acc.z += s * x.z;
  acc.w += s * x.w;
}

// columns j..j+3 of an adjacency row (0 beyond n); float4 when n % 4 == 0
__device__ __forceinline__ float4 load_row4(const float* __restrict__ row, int j,
                                            int n, bool vec) {
  if (vec) {
    return j < n ? *reinterpret_cast<const float4*>(row + j) : make_float4(0, 0, 0, 0);
  }
  return make_float4(j < n ? row[j] : 0.0f, j + 1 < n ? row[j + 1] : 0.0f,
                     j + 2 < n ? row[j + 2] : 0.0f, j + 3 < n ? row[j + 3] : 0.0f);
}

__device__ __forceinline__ unsigned nibble(float4 a) {
  return (unsigned)(a.x > 0.0f) | ((unsigned)(a.y > 0.0f) << 1)
         | ((unsigned)(a.z > 0.0f) << 2) | ((unsigned)(a.w > 0.0f) << 3);
}

// ---- phase clocks (compiled in with -DGAT_PHASE_CLOCKS only) ----
// Thread 0 of each CTA stamps %globaltimer (ns) and its SM at the phase
// boundaries into gat_clocks[cta][0..7]; gat_attention_clocks copies them
// out.  Off in the port's build: PHASE_MARK is empty.
#ifdef GAT_PHASE_CLOCKS
constexpr int kClockSlots = 8;
constexpr int kClockCtas = 8192;
__device__ unsigned long long gat_clocks[kClockCtas * kClockSlots];
#define PHASE_MARK(k)                                                          \
  do {                                                                         \
    if (threadIdx.x == 0 && blockIdx.x < kClockCtas) {                         \
      unsigned long long t;                                                    \
      unsigned sm;                                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                    \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));                          \
      gat_clocks[blockIdx.x * kClockSlots + (k)] = (t << 8) | (sm & 0xffu);    \
    }                                                                          \
  } while (0)
#else
#define PHASE_MARK(k) \
  do {                \
  } while (0)
#endif

// ---- bulk copies (TMA) into shared memory, completing on an mbarrier ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

// The block copies `rows` rows of `row_floats` floats (16-byte multiples),
// the source rows `stride` floats apart, into dst (contiguous rows), a
// thread per row; thread 0 armed the barrier with expect_rows.
__device__ __forceinline__ void expect_rows(int rows, int row_floats, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"((uint32_t)row_floats * 4u * (uint32_t)rows)
               : "memory");
}

__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows,
                                           int row_floats, size_t stride,
                                           uint64_t* bar) {
  const uint32_t row_bytes = (uint32_t)row_floats * 4u;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem_addr(dst + (size_t)r * row_floats)), "l"(src + (size_t)r * stride),
        "r"(row_bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

// ---- the structural bitmap, shared by the CTAs of a cluster ----

// Rows r0..r1-1 of the structural bitmap (bit j % 32 of word
// kbits[i * words + j / 32] is adjs[i, j] > 0), read with float4 loads
// spread flat over the block, eight in flight a thread.  A row is read as
// 8 * words float4 slots (zeros past n), so eight neighbouring lanes hold
// the 32 columns of one word.
__device__ __forceinline__ void build_bits(const float* __restrict__ adjs_b, int n,
                                           int words, int r0, int r1,
                                           uint32_t* kbits) {
  constexpr int kInFlight = 8;
  const int lane = threadIdx.x & 31;
  const bool vec = (n & 3) == 0;
  const int per_row = 8 * words;
  const int total = (r1 - r0) * per_row;
  for (int f0 = threadIdx.x; f0 - lane < total; f0 += kInFlight * blockDim.x) {
    float4 a[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int f = f0 + u * blockDim.x;
      const int i = r0 + f / per_row;
      a[u] = f < total ? load_row4(adjs_b + (size_t)i * n, 4 * (f % per_row), n, vec)
                       : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int f = f0 + u * blockDim.x;
      if (f - lane >= total) break;           // uniform across the warp
      unsigned wv = nibble(a[u]) << (4 * (lane & 7));
      wv |= __shfl_xor_sync(kFull, wv, 1);
      wv |= __shfl_xor_sync(kFull, wv, 2);
      wv |= __shfl_xor_sync(kFull, wv, 4);
      if ((lane & 7) == 0 && f < total)
        kbits[(size_t)(r0 + f / per_row) * words + (f % per_row) / 8] = wv;
    }
  }
}

// Each CTA of the cluster builds its share of the rows (ceil(n / size)
// each), then copies the others' shares from their shared memory.  The
// caller waits on the cluster barrier (barrier_wait) before it leaves, so
// that no CTA leaves while another may still read its bitmap.
__device__ __forceinline__ void cluster_bits(cg::cluster_group& cluster,
                                             const float* __restrict__ adjs_b, int n,
                                             int words, uint32_t* kbits) {
  const int size = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int per = (n + size - 1) / size;
  build_bits(adjs_b, n, words, min(n, rank * per), min(n, (rank + 1) * per), kbits);
  cluster.sync();
  for (int k = threadIdx.x; k < n * words; k += blockDim.x) {
    const int owner = k / words / per;
    if (owner != rank) kbits[k] = *cluster.map_shared_rank(kbits + k, owner);
  }
  cluster.barrier_arrive();
  __syncthreads();
}

// rank of row i among the set bits of column bitmap cb (bits below i)
__device__ __forceinline__ int col_rank(const uint32_t* cb, int i) {
  const int wi = i >> 5;
  int r = 0;
  for (int w = 0; w < wi; ++w) r += __popc(cb[w]);
  return r + __popc(cb[wi] & ((1u << (i & 31)) - 1u));
}

// start[0..n] = exclusive scan of the bit counts of bitmap rows (or
// columns) 0..n-1 (all threads)
__device__ void scan_bits(const uint32_t* bits, int words, int n, int* start,
                          int* tmp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per);
  const int hi = min(n, lo + per);
  int s = 0;
  for (int k = lo; k < hi; ++k)
    for (int w = 0; w < words; ++w) s += __popc(bits[(size_t)k * words + w]);
  const int x = warp_incl_scan(s);
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_incl_scan(lane < nwarps ? tmp[lane] : 0);
    __syncwarp();
    tmp[lane] = t;
  }
  __syncthreads();
  int base = (warp ? tmp[warp - 1] : 0) + x - s;
  for (int k = lo; k < hi; ++k) {
    start[k] = base;
    for (int w = 0; w < words; ++w) base += __popc(bits[(size_t)k * words + w]);
  }
  if (threadIdx.x == blockDim.x - 1) start[n] = base;
  __syncthreads();
}

template <int kChunks>
__device__ __forceinline__ void load_rows(float4 (&x)[kChunks], const float* row,
                                          int dh, bool valid) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int d = 128 * q + 4 * lane;
    x[q] = valid && d < dh ? *reinterpret_cast<const float4*>(row + d)
                           : make_float4(0, 0, 0, 0);
  }
}

// A half-warp's share of a (node, head) row: lane hl of the half holds
// features 128 q + 8 hl .. + 7 as x[2q], x[2q+1] (zeros past dh or unless
// valid).
template <int kChunks>
__device__ __forceinline__ void load_half(float4 (&x)[2 * kChunks], const float* row,
                                          int dh, int hl, bool valid) {
#pragma unroll
  for (int q = 0; q < 2 * kChunks; ++q) {
    const int d = 128 * (q >> 1) + 8 * hl + 4 * (q & 1);
    x[q] = valid && d < dh ? *reinterpret_cast<const float4*>(row + d)
                           : make_float4(0, 0, 0, 0);
  }
}

// ---- forward ----

// shared memory: mbarrier (16 B) | v slice [n, dhc] f32 | a_n, a_s, rm, D
// [n] f32 | rowstart [n+1] i32 | tmp [32] i32 | kbits [n * words] u32 |
// slots: e [edge_cap] f32, column and row [edge_cap] u16 each.  The
// scratch (when a subgraph has more than edge_cap edges): [grid, n*n] f32
// slots, then per CTA n*n u16 columns and n*n u16 rows.
template <int kLevel, int kChunks>
__global__ void __launch_bounds__(512, 2)
gat_fwd_kernel(const float* __restrict__ a_s, const float* __restrict__ a_n,
               const float* __restrict__ v, const float* __restrict__ adjn,
               const float* __restrict__ adjs, float* __restrict__ out,
               unsigned char* __restrict__ scratch, int n, int h, int dh,
               int split, int edge_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int dhc = dh / split;
  const int c = blockIdx.x % split;
  const int hh = (blockIdx.x / split) % h;
  const int b = blockIdx.x / (split * h);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int words = (n + 31) >> 5;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* vs = reinterpret_cast<float*>(smem + 16);
  float* an = vs + (size_t)n * dhc;
  float* asv = an + n;
  float* rmv = asv + n;
  float* den = rmv + n;
  int* rowstart = reinterpret_cast<int*>(den + n);
  int* tmp = rowstart + n + 1;
  uint32_t* kbits = reinterpret_cast<uint32_t*>(tmp + 32);
  float* slot_s = reinterpret_cast<float*>(kbits + (size_t)n * words);
  uint16_t* col_s = reinterpret_cast<uint16_t*>(slot_s + edge_cap);
  uint16_t* row_s = col_s + edge_cap;

  PHASE_MARK(0);
  const size_t att = ((size_t)b * h + hh) * n;
  const size_t rs = (size_t)h * dh;                       // node row stride
  const size_t vbase = (size_t)b * n * rs + (size_t)hh * dh + (size_t)c * dhc;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    expect_rows(n, dhc, bar);
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    an[j] = a_n[att + j];
    asv[j] = a_s[att + j];
  }
  __syncthreads();

  // (1) the structural bitmap of every row, built by the cluster; then
  // v's slice is staged
  cluster_bits(cluster, adjs + (size_t)b * n * n, n, words, kbits);
  stage_rows(vs, v + vbase, n, dhc, rs, bar);
  PHASE_MARK(1);

  // (2) the edges numbered in row order: each row's first slot, each
  // slot's column and row; each row's max
  scan_bits(kbits, words, n, rowstart, tmp);
  const int edges = rowstart[n];
  const size_t nn = (size_t)n * n;
  const bool spill = edges > edge_cap;
  float* slot = spill ? reinterpret_cast<float*>(scratch) + blockIdx.x * nn : slot_s;
  uint16_t* slot_col = spill ? reinterpret_cast<uint16_t*>(
                                   scratch + (size_t)gridDim.x * nn * 4) + 2 * blockIdx.x * nn
                             : col_s;
  uint16_t* slot_row = spill ? slot_col + nn : row_s;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int pos = rowstart[i];
    float m = -INFINITY;
    for (int w = 0; w < words; ++w) {
      for (uint32_t bits = kbits[(size_t)i * words + w]; bits; bits &= bits - 1u) {
        const int j = 32 * w + __ffs(bits) - 1;
        m = fmaxf(m, asv[i] + an[j]);
        slot_col[pos] = (uint16_t)j;
        slot_row[pos++] = (uint16_t)i;
      }
    }
    rmv[i] = isfinite(m) ? m : 0.0f;
  }
  __syncthreads();
  PHASE_MARK(2);

  // (3) e once per structural edge, a thread per edge (every adjn read in
  // flight at once); D per row in ascending j
  const float* adjn_b = adjn + (size_t)b * nn;
  for (int pos = threadIdx.x; pos < edges; pos += blockDim.x) {
    const int i = slot_row[pos];
    const int j = slot_col[pos];
    slot[pos] = edge_exp<kLevel>((asv[i] + an[j]) - rmv[i]) * adjn_b[(size_t)i * n + j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float dsum = 0.0f;
    for (int pos = rowstart[i]; pos < rowstart[i + 1]; ++pos) dsum += slot[pos];
    den[i] = fmaxf(dsum, 1e-10f);
  }
  __syncthreads();
  PHASE_MARK(3);

  // (4) a warp per row gathers the listed rows of the staged v slice as
  // float4 in ascending j, and writes out as float4
  mbar_wait(bar);
  for (int i = warp; i < n; i += nwarps) {
    float4 acc[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) acc[q] = make_float4(0, 0, 0, 0);
    const int end = rowstart[i + 1];
    for (int pos = rowstart[i]; pos < end; ++pos) {
      const float e = slot[pos];
      if (e == 0.0f) continue;                 // dropped edge: adds nothing
      const float eo = operand<kLevel>(e);
      const float* vr = vs + (size_t)slot_col[pos] * dhc;
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int d = 128 * q + 4 * lane;
        if (d < dhc)
          fma4(acc[q], eo, operand4<kLevel>(*reinterpret_cast<const float4*>(vr + d)));
      }
    }
    const float dn = den[i];
    float* orow = out + vbase + (size_t)i * rs;
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int d = 128 * q + 4 * lane;
      if (d < dhc)
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[q].x / dn, acc[q].y / dn, acc[q].z / dn, acc[q].w / dn);
    }
  }
  __syncthreads();
  PHASE_MARK(4);
  cluster.barrier_wait();
}

// ---- backward ----

// shared memory: mbarrier (16 B) | g slice [n, dh] f32 (when staged) |
// a_n, a_s, rm, D, r [n] f32 | colstart [n+1] i32 | tmp [32] i32 |
// kbits, cbits [n * words] u32 | slots: P then ds [edge_cap] f32, row and
// column [edge_cap] u16 each.  The scratch (when a subgraph has more than
// edge_cap edges): [grid, n*n] f32 slots, then per CTA n*n u16 rows and
// n*n u16 columns.
template <int kLevel, int kChunks>
__global__ void __launch_bounds__(512, 2)
gat_bwd_kernel(const float* __restrict__ a_s, const float* __restrict__ a_n,
               const float* __restrict__ v, const float* __restrict__ adjn,
               const float* __restrict__ adjs, const float* __restrict__ out,
               const float* __restrict__ g, float* __restrict__ das,
               float* __restrict__ dan, float* __restrict__ dv,
               unsigned char* __restrict__ scratch, int n, int h, int dh,
               int staged, int edge_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int hh = blockIdx.x % h;
  const int b = blockIdx.x / h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int words = (n + 31) >> 5;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* gs = reinterpret_cast<float*>(smem + 16);
  float* an = gs + (staged ? (size_t)n * dh : 0);
  float* asv = an + n;
  float* rmv = asv + n;
  float* dv_den = rmv + n;
  float* rv = dv_den + n;
  int* colstart = reinterpret_cast<int*>(rv + n);
  int* tmp = colstart + n + 1;
  uint32_t* kbits = reinterpret_cast<uint32_t*>(tmp + 32);
  uint32_t* cbits = kbits + (size_t)n * words;
  float* slot_s = reinterpret_cast<float*>(cbits + (size_t)n * words);
  uint16_t* row_s = reinterpret_cast<uint16_t*>(slot_s + edge_cap);
  uint16_t* col_s = row_s + edge_cap;

  PHASE_MARK(0);
  const size_t att = ((size_t)b * h + hh) * n;
  const size_t rs = (size_t)h * dh;
  const size_t base = (size_t)b * n * rs + (size_t)hh * dh;
  if (staged && threadIdx.x == 0) {
    mbar_init(bar);
    expect_rows(n, dh, bar);
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    an[j] = a_n[att + j];
    asv[j] = a_s[att + j];
  }
  __syncthreads();

  // (1) the structural bitmap of every row, built by the cluster; then
  // g's slice is staged
  cluster_bits(cluster, adjs + (size_t)b * n * n, n, words, kbits);
  if (staged) stage_rows(gs, g + base, n, dh, rs, bar);
  PHASE_MARK(1);

  // (2) column bitmaps: 32 x 32 tiles transposed with ballots; then the
  // column starts of the edges numbered in column order
  for (int t = warp; t < words * words; t += nwarps) {
    const int rw = t / words;
    const int cw = t - rw * words;
    const int i = 32 * rw + lane;
    const uint32_t x = i < n ? kbits[(size_t)i * words + cw] : 0u;
    uint32_t mine = 0;
#pragma unroll 8
    for (int q = 0; q < 32; ++q) {
      const uint32_t y = __ballot_sync(kFull, (x >> q) & 1u);
      if (lane == q) mine = y;
    }
    const int j = 32 * cw + lane;
    if (j < n) cbits[(size_t)j * words + rw] = mine;
  }
  __syncthreads();
  scan_bits(cbits, words, n, colstart, tmp);
  const int edges = colstart[n];
  const bool spill = edges > edge_cap;
  const size_t nn = (size_t)n * n;
  float* slot = spill ? reinterpret_cast<float*>(scratch) + blockIdx.x * nn : slot_s;
  uint16_t* slot_row = spill ? reinterpret_cast<uint16_t*>(
                                   scratch + (size_t)gridDim.x * nn * 4) + 2 * blockIdx.x * nn
                             : row_s;
  uint16_t* slot_col = spill ? slot_row + nn : col_s;
  // each edge's row and column, in column order; each row's max
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int pos = colstart[j];
    for (int w = 0; w < words; ++w) {
      for (uint32_t bits = cbits[(size_t)j * words + w]; bits; bits &= bits - 1u) {
        slot_row[pos] = (uint16_t)(32 * w + __ffs(bits) - 1);
        slot_col[pos++] = (uint16_t)j;
      }
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float m = -INFINITY;
    for (int w = 0; w < words; ++w)
      for (uint32_t bits = kbits[(size_t)i * words + w]; bits; bits &= bits - 1u)
        m = fmaxf(m, asv[i] + an[32 * w + __ffs(bits) - 1]);
    rmv[i] = isfinite(m) ? m : 0.0f;
  }
  __syncthreads();
  PHASE_MARK(2);

  // (3) e once per structural edge, a thread per edge (every adjn read in
  // flight at once); D per row in ascending j (P = e / D is formed in 4)
  const int half = lane >> 4;
  const int hl = lane & 15;
  float4 vn[2 * kChunks];
  load_half<kChunks>(vn, v + base + (size_t)(2 * warp + half) * rs, dh, hl,
                     2 * warp + half < n);
  const float* adjn_b = adjn + (size_t)b * nn;
  for (int pos = threadIdx.x; pos < edges; pos += blockDim.x) {
    const int i = slot_row[pos];
    const int j = slot_col[pos];
    slot[pos] = edge_exp<kLevel>((asv[i] + an[j]) - rmv[i]) * adjn_b[(size_t)i * n + j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float dsum = 0.0f;
    for (int w = 0; w < words; ++w) {
      for (uint32_t bits = kbits[(size_t)i * words + w]; bits; bits &= bits - 1u) {
        const int j = 32 * w + __ffs(bits) - 1;
        dsum += slot[colstart[j] + col_rank(cbits + (size_t)j * words, i)];
      }
    }
    dv_den[i] = fmaxf(dsum, 1e-10f);
  }
  PHASE_MARK(3);
  if (staged) mbar_wait(bar);
  const float* gsrc = staged ? gs : g + base;
  const size_t gstride = staged ? (size_t)dh : rs;
  // r = g.out (the unrounded g), a warp per row, four rows' out in flight
  for (int i0 = warp; i0 < n; i0 += 4 * nwarps) {
    float4 orow[4][kChunks];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      load_rows<kChunks>(orow[u], out + base + (size_t)(i0 + u * nwarps) * rs, dh,
                         i0 + u * nwarps < n);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nwarps;
      if (i >= n) break;
      float r = 0.0f;
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int d = 128 * q + 4 * lane;
        if (d < dh)
          r += dot4(*reinterpret_cast<const float4*>(gsrc + (size_t)i * gstride + d),
                    orow[u][q]);
      }
      r = warp_sum(r);
      if (lane == 0) rv[i] = r;
    }
  }
  __syncthreads();
  PHASE_MARK(4);

  // (4) per column: P and g.v once per kept edge, da_n and dv summed in ascending
  // i in registers; ds back into the slot.  A half-warp per column (a lane
  // owns 8 features of each 128), two columns a warp, each pair's v loaded
  // one step ahead (the first during step 3).
  for (int j0 = 2 * warp; j0 < n; j0 += 2 * nwarps) {
    const int j = j0 + half;
    float4 vj[2 * kChunks], acc[2 * kChunks];
#pragma unroll
    for (int q = 0; q < 2 * kChunks; ++q) {
      vj[q] = operand4<kLevel>(vn[q]);
      acc[q] = make_float4(0, 0, 0, 0);
    }
    const int jn = j + 2 * nwarps;
    load_half<kChunks>(vn, v + base + (size_t)jn * rs, dh, hl, jn < n);
    const int beg = j < n ? colstart[j] : 0;
    const int cnt = j < n ? colstart[j + 1] - beg : 0;
    const int steps = max(cnt, __shfl_xor_sync(kFull, cnt, 16));
    float dan_sum = 0.0f;
    for (int k = 0; k < steps; ++k) {        // uniform across the warp
      const int pos = beg + k;
      const float e = k < cnt ? slot[pos] : 0.0f;
      const bool use = e != 0.0f;            // P = 0: ds = 0, already in the slot
      const int i = use ? slot_row[pos] : 0;
      const float p = use ? e / dv_den[i] : 0.0f;
      float4 gi[2 * kChunks];
      load_half<kChunks>(gi, gsrc + (size_t)i * gstride, dh, hl, use);
      float gv = 0.0f;
#pragma unroll
      for (int q = 0; q < 2 * kChunks; ++q) {
        gi[q] = operand4<kLevel>(gi[q]);
        gv += dot4(gi[q], vj[q]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) gv += __shfl_xor_sync(kFull, gv, o);
      if (use) {
        const float ds = p * (gv - rv[i]);
        dan_sum += ds;
        const float pd = operand<kLevel>(p);
#pragma unroll
        for (int q = 0; q < 2 * kChunks; ++q) fma4(acc[q], pd, gi[q]);
        if (hl == 0) slot[pos] = ds;         // the half read p before the shuffles
      }
    }
    if (j < n) {
      float* dvr = dv + base + (size_t)j * rs;
#pragma unroll
      for (int q = 0; q < 2 * kChunks; ++q) {
        const int d = 128 * (q >> 1) + 8 * hl + 4 * (q & 1);
        if (d < dh) *reinterpret_cast<float4*>(dvr + d) = acc[q];
      }
      if (hl == 0) dan[att + j] = dan_sum;
    }
  }
  __syncthreads();
  PHASE_MARK(5);

  // (5) da_s: each row's slots in ascending j
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t* kb = kbits + (size_t)i * words;
    float s = 0.0f;
    for (int w = 0; w < words; ++w) {
      for (uint32_t bits = kb[w]; bits; bits &= bits - 1u) {
        const int j = 32 * w + __ffs(bits) - 1;
        s += slot[colstart[j] + col_rank(cbits + (size_t)j * words, i)];
      }
    }
    das[att + i] = s;
  }
  __syncthreads();
  PHASE_MARK(6);
  cluster.barrier_wait();
}

template <typename K>
int set_smem(K kernel, int smem_bytes) {
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    (int)cudaSharedmemCarveoutMaxShared);
  if (e != 0 || smem_bytes <= 48 * 1024) return e;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

template <typename K, typename... Args>
int launch(K kernel, int grid, int cluster, int threads, int smem_bytes,
           void* stream, Args... args) {
  const int e = set_smem(kernel, smem_bytes);
  if (e != 0) return e;
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int kLevel, int kChunks>
int forward_level(const void* a_s, const void* a_n, const void* v, const void* adjn,
                  const void* adjs, void* out, void* scratch, int n, int h, int dh,
                  int split, int edge_cap, int grid, int cluster, int threads,
                  int smem_bytes, void* stream) {
  return launch(gat_fwd_kernel<kLevel, kChunks>, grid, cluster, threads, smem_bytes,
                stream, static_cast<const float*>(a_s), static_cast<const float*>(a_n),
                static_cast<const float*>(v), static_cast<const float*>(adjn),
                static_cast<const float*>(adjs), static_cast<float*>(out),
                static_cast<unsigned char*>(scratch), n, h, dh, split, edge_cap);
}

template <int kLevel, int kChunks>
int backward_level(const void* a_s, const void* a_n, const void* v,
                   const void* adjn, const void* adjs, const void* out,
                   const void* g, void* das, void* dan, void* dv, void* scratch,
                   int n, int h, int dh, int staged, int edge_cap, int grid,
                   int cluster, int threads, int smem_bytes, void* stream) {
  return launch(gat_bwd_kernel<kLevel, kChunks>, grid, cluster, threads, smem_bytes,
                stream, static_cast<const float*>(a_s), static_cast<const float*>(a_n),
                static_cast<const float*>(v), static_cast<const float*>(adjn),
                static_cast<const float*>(adjs), static_cast<const float*>(out),
                static_cast<const float*>(g), static_cast<float*>(das),
                static_cast<float*>(dan), static_cast<float*>(dv),
                static_cast<unsigned char*>(scratch), n, h, dh, staged, edge_cap);
}

}  // namespace

extern "C" {

// Grids, blocks, dh split, staging, slot capacity and dynamic shared memory
// come from the caller (shadow_gnn_torch/ops/gat.py:launch_dims); `level`
// is kLevel (0, 1, 2).  Each launches one kernel on `stream` and returns
// cudaGetLastError() after it (0 = launched; cudaErrorInvalidValue for an
// unknown level).

// kChunks: 128-feature chunks of a (node, head) row, 1 for dh <= 128
#define GAT_DISPATCH(fn, ...)                                              \
  switch (level * 2 + (chunks == 2)) {                                     \
    case 0: return fn<0, 1>(__VA_ARGS__);                                  \
    case 1: return fn<0, 2>(__VA_ARGS__);                                  \
    case 2: return fn<1, 1>(__VA_ARGS__);                                  \
    case 3: return fn<1, 2>(__VA_ARGS__);                                  \
    case 4: return fn<2, 1>(__VA_ARGS__);                                  \
    case 5: return fn<2, 2>(__VA_ARGS__);                                  \
    default: return (int)cudaErrorInvalidValue;                            \
  }

// `scratch` holds the edge slots of a subgraph with more than edge_cap
// structural edges (null when none can have).
int gat_attention_forward(const void* a_s, const void* a_n, const void* v,
                          const void* adjn, const void* adjs, void* out,
                          void* scratch, int n, int h, int dh, int split,
                          int edge_cap, int chunks, int grid, int cluster,
                          int threads, int smem_bytes, int level, void* stream) {
  if (chunks != 1 && chunks != 2) return (int)cudaErrorInvalidValue;
  GAT_DISPATCH(forward_level, a_s, a_n, v, adjn, adjs, out, scratch, n, h, dh, split,
               edge_cap, grid, cluster, threads, smem_bytes, stream)
}

// da_s, da_n and dv in one launch; `scratch` as in the forward.
int gat_attention_backward(const void* a_s, const void* a_n, const void* v,
                           const void* adjn, const void* adjs, const void* out,
                           const void* g, void* das, void* dan, void* dv,
                           void* scratch, int n, int h, int dh, int staged,
                           int edge_cap, int chunks, int grid, int cluster,
                           int threads, int smem_bytes, int level, void* stream) {
  if (chunks != 1 && chunks != 2) return (int)cudaErrorInvalidValue;
  GAT_DISPATCH(backward_level, a_s, a_n, v, adjn, adjs, out, g, das, dan, dv, scratch,
               n, h, dh, staged, edge_cap, grid, cluster, threads, smem_bytes, stream)
}

// CTAs of the forward (which 0) or backward (1) kernel that one SM holds
// at `threads` threads and `smem_bytes` of dynamic shared memory (level 0)
int gat_attention_occupancy(int which, int threads, int smem_bytes) {
  int blocks = -1;
  const int e = which ? set_smem(gat_bwd_kernel<0, 1>, smem_bytes)
                      : set_smem(gat_fwd_kernel<0, 1>, smem_bytes);
  if (e != 0) return -e;
  if (which)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gat_bwd_kernel<0, 1>, threads,
                                                  smem_bytes);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gat_fwd_kernel<0, 1>, threads,
                                                  smem_bytes);
  return blocks;
}

#ifdef GAT_PHASE_CLOCKS
int gat_attention_clocks(void* dst, int ctas) {
  return (int)cudaMemcpyFromSymbol(dst, gat_clocks,
                                   sizeof(unsigned long long) * kClockSlots * ctas);
}
#endif

}  // extern "C"
