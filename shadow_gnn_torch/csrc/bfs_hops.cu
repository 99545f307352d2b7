// bfs_hops for sm_90a: batched multi-source BFS over dense subgraph blocks.
//
//   dist[b, s, j] = BFS distance from starts[b, s] to node j of block b,
//                   along out-edges (adj[b, i, j] > 0 is the edge i -> j),
//                   -1 for unreachable nodes and padding
//   adj [B, N, N] f32, node_mask [B, N] bool (as bytes), starts [B, S] int64
//   -> dist [B, S, N] int64
//
// The start node gets 0 whatever its mask, as in the plain version
// (shadow_gnn_torch/ops/bfs.py:bfs_hops_plain); a start outside [0, N)
// reaches nothing.  A level sets dist[j] = lvl + 1 for every unvisited
// valid j whose SUM over the frontier rows, sum_i adj[i, j], is > 0: the
// plain version's bmm(frontier, adj) > 0.  A sum, not "any entry > 0": the
// link task's target-edge removal multiplies the block by 1 - t t^T, where
// t is 2 at a node that a pair repeats, so a block may hold -1 and -3.
// The blocks hold small integers (0/1 edges, self edges, -1 and -3), so
// their int32 sums, in any order, atomics included, equal the plain
// version's f32 sums (exact: |sum| <= 3 N < 2^24), and the kernel equals
// the plain version bit for bit.
//
// Not a TPU kernel's port: the counterpart of the JAX package's device
// loop (shadow_gnn_tpu/sampling/induction.py: bfs_hops_multi, a
// lax.while_loop).  The levels loop on the device until the frontier is
// empty, so one launch holds the whole BFS and a CUDA graph can hold it.
//
// What bounds it.  A source needs the rows of the nodes it reaches, 4 N
// bytes each, read once, plus the mask and its int64 output row: 2-3 us
// of bytes at 3.35 TB/s at the main path's shapes (B=64, N=208, S=1: the
// cold step's hops; B=16, N=408, S=2: the link task's DRNL).  A level
// cannot start before the last one ended, so the real floor is the chain
// of levels (2-4 on the cold step's PPR subgraphs, one of them about 200
// rows wide; 9-10 on DRNL's), each a dependent L2 read, a reduction and
// a barrier: latency, not bytes.
//
// Design.  B * S thread-block clusters of C CTAs (C = 1, 2, 4 or 8;
// ops/bfs.py:launch_dims: where N >= 256, the largest C whose B * S * C
// CTAs fit one an SM; one CTA a source below N = 256 or where B * S
// passes the SM count), one cluster per (subgraph, source).  CTA r owns
// the 4-column groups r, r + C, r + 2C, ...: their int32 sums (two
// buffers, by level parity), their distances (int16) and the frontier
// nodes it found, each warp a contiguous share of the groups and its own
// list of the nodes it found.  Before the first level every CTA zeroes
// its sums behind a cluster barrier (arrive, then wait after its own
// set-up): no CTA pushes into another before that one has started and
// zeroed.  A level:
//  1. push: each warp reads the rows of its own frontier nodes, 8 (then
//     4, 2, 1) rows at a time, a lane loading 16 bytes at pieces i and
//     i + 32 of each (4-byte pieces where N % 4 != 0); the rows' sum of
//     each piece (exact: small integers) goes, where nonzero, to the
//     owner of its columns as int32 atomics (remote ones through
//     distributed shared memory).  The sums are laid out component-major
//     in chunks of 32 groups, so a warp's adds fall in 32 distinct banks;
//  2. the level's one barrier: cluster.sync() (release / acquire), or
//     __syncthreads() where C = 1;
//  3. each warp reads and clears its groups' sums, sets dist = lvl + 1
//     where the sum is > 0 on an unvisited valid node, and compacts the
//     new nodes into its list with ballots (no shared counter); a warp
//     that found any stamps lvl + 1 into every CTA's `live` word, and
//     after the next barrier `live` < lvl + 1 means the frontier was
//     empty: every CTA reads the same and leaves the loop together.
// int32, not f32: shared memory has no native f32 atomic add on sm_90
// (atomicAdd(float*) there compiles to a compare-and-swap loop).  Why
// N = 256: the cluster's barrier costs more than __syncthreads() (its
// release fence at cluster scope) and a remote add more than a local
// one, which the split of a level's rows repays only once the rows are
// long: on an H100 80GB HBM3 one CTA a source won at N = 208 and a
// cluster at N = 408 and above (chip_smoke.py [bfs] logs both sides of
// the rule on hub blocks at N = 208, 408 and 907, and [power] / [link]
// bfs_hops on the main path's blocks; PERF.md keeps the times).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KTHREADS = 256;
constexpr int KWARPS = KTHREADS / 32;
constexpr int KMAX_N = 16384;          // u16 lists, int16 distances
constexpr unsigned KFULL = 0xffffffffu;

// A CTA's accumulator holds its w columns in chunks of 32 4-column groups,
// component-major within a chunk: component c of local group g at
// (g / 32) 128 + 32 c + g % 32, so that a warp's adds to the components c
// of 32 consecutive groups fall in 32 distinct banks.
__host__ __device__ constexpr int acc_words(int w) { return (w + 127) / 128 * 128; }

// Shared memory of a CTA that owns w columns (w % 4 == 0):
// acc [2][acc_words(w)] i32 | live i32 (16 bytes) | dist [w] i16 | list [w] u16
constexpr int smem_bytes(int w) { return 8 * acc_words(w) + 16 + 4 * w; }

// Component 0 of the global 4-column group `quad` in the accumulator of
// the CTA that owns it: CTA r of a cluster of 2^logc owns the groups r,
// r + 2^logc, ... (its local groups 0, 1, ...).
template <bool kCluster>
__device__ __forceinline__ int* owner_acc(cg::cluster_group& cluster, int* acc, int quad,
                                          int logc) {
  const int g = quad >> logc;
  int* base = kCluster ? cluster.map_shared_rank(acc, quad & ((1 << logc) - 1)) : acc;
  return base + (g >> 5) * 128 + (g & 31);
}

__device__ __forceinline__ void add(int* d, float x) {
  if (x != 0.f) atomicAdd(d, __float2int_rn(x));
}

__device__ __forceinline__ float4 plus(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}
__device__ __forceinline__ float plus(float x, float y) { return x + y; }

// Adds piece i of a row (V = float4: the group i; V = float: column i).
template <bool kCluster>
__device__ __forceinline__ void add_piece(cg::cluster_group& cluster, int* acc, int logc,
                                          int i, float4 v) {
  if ((__float_as_uint(v.x) | __float_as_uint(v.y) | __float_as_uint(v.z) |
       __float_as_uint(v.w)) << 1 == 0)
    return;                                           // four zeros (either sign)
  int* d = owner_acc<kCluster>(cluster, acc, i, logc);
  add(d, v.x);
  add(d + 32, v.y);
  add(d + 64, v.z);
  add(d + 96, v.w);
}

template <bool kCluster>
__device__ __forceinline__ void add_piece(cg::cluster_group& cluster, int* acc, int logc,
                                          int i, float x) {
  if (x != 0.f) add(owner_acc<kCluster>(cluster, acc, i >> 2, logc) + 32 * (i & 3), x);
}

// Adds the R rows list[0 .. R) of the block `a` into their owners'
// accumulators: a lane loads pieces i and i + 32 of each row (V: float4
// where every row is 16-byte aligned, else float), 2 R loads in flight,
// and adds the rows' sum of each piece (exact: small integers).
template <int R, typename V, bool kCluster>
__device__ __forceinline__ void push_group(cg::cluster_group& cluster,
                                           const float* __restrict__ a, int n,
                                           const uint16_t* list, int* acc, int logc,
                                           int lane) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int pieces = n / kW;
  const V* p[R];
#pragma unroll
  for (int u = 0; u < R; ++u)
    p[u] = reinterpret_cast<const V*>(a + static_cast<size_t>(list[u]) * n);
  for (int i = lane; i < pieces; i += 64) {
    const bool two = i + 32 < pieces;
    V v[R][2];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      v[u][0] = __ldg(p[u] + i);
      if (two) v[u][1] = __ldg(p[u] + i + 32);
    }
#pragma unroll
    for (int u = 1; u < R; ++u) {
      v[0][0] = plus(v[0][0], v[u][0]);
      if (two) v[0][1] = plus(v[0][1], v[u][1]);
    }
    add_piece<kCluster>(cluster, acc, logc, i, v[0][0]);
    if (two) add_piece<kCluster>(cluster, acc, logc, i + 32, v[0][1]);
  }
}

// Adds the rows list[0 .. nf) (warp-uniform nf), 8 at a time, then 4, 2, 1.
template <typename V, bool kCluster>
__device__ __forceinline__ void push_rows(cg::cluster_group& cluster,
                                          const float* __restrict__ a, int n,
                                          const uint16_t* list, int nf, int* acc,
                                          int logc, int lane) {
  int k = 0;
  for (; k + 8 <= nf; k += 8)
    push_group<8, V, kCluster>(cluster, a, n, list + k, acc, logc, lane);
  if (k + 4 <= nf) {
    push_group<4, V, kCluster>(cluster, a, n, list + k, acc, logc, lane);
    k += 4;
  }
  if (k + 2 <= nf) {
    push_group<2, V, kCluster>(cluster, a, n, list + k, acc, logc, lane);
    k += 2;
  }
  if (k < nf) push_group<1, V, kCluster>(cluster, a, n, list + k, acc, logc, lane);
}

template <bool kCluster>
__global__ void __launch_bounds__(KTHREADS, 2)
bfs_kernel(const float* __restrict__ adj, const uint8_t* __restrict__ mask,
           const int64_t* __restrict__ starts, int64_t* __restrict__ out, int n, int s,
           int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = kCluster ? static_cast<int>(cluster.num_blocks()) : 1;
  const int rank = kCluster ? static_cast<int>(cluster.block_rank()) : 0;
  const int logc = __ffs(csize) - 1;
  const int words = acc_words(w);
  int* acc = reinterpret_cast<int*>(smem);                      // [2][words]
  int* live = acc + 2 * words;                                  // the last live level
  int16_t* dist = reinterpret_cast<int16_t*>(live + 4);         // [w]
  uint16_t* list = reinterpret_cast<uint16_t*>(dist + w);       // [w]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bs = blockIdx.x / csize;                  // b * s + source
  const float* a = adj + static_cast<size_t>(bs / s) * n * n;
  const uint8_t* m = mask + static_cast<size_t>(bs / s) * n;
  const int64_t start = starts[bs];
  // my groups: the global 4-column groups rank, rank + csize, ... below
  // ceil(n / 4); local group g is global group g * csize + rank
  const int groups = ((n + 3) / 4 - rank + csize - 1) / csize;
  const int gb = warp * groups / KWARPS;              // the warp's local groups
  const int ge = (warp + 1) * groups / KWARPS;        // [gb, ge); its frontier
  uint16_t* wlist = list + 4 * gb;                    // list[4 gb ..)
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(adj) & 15) == 0;

  for (int k = tid; k < words / 2; k += KTHREADS)
    reinterpret_cast<int4*>(acc)[k] = make_int4(0, 0, 0, 0);
  // the first push may land in any CTA of the cluster: none may push
  // before every CTA has started and zeroed its sums (the wait below)
  if (kCluster) cluster.barrier_arrive();
  // -1 unvisited, -2 never (padding, columns past n); the start 0 whatever
  // its mask (the mask loads go out before the start is needed)
  for (int t = tid; t < 4 * groups; t += KTHREADS) {
    const int col = 4 * ((t >> 2) * csize + rank) + (t & 3);
    const bool valid = col < n && m[col];
    dist[t] = col == start ? 0 : (valid ? -1 : -2);
  }
  const bool start_in = start >= 0 && start < n;
  if (tid == 0) live[0] = start_in ? 0 : -1;
  int nf = 0;                                         // the warp's frontier rows
  if (start_in && ((start >> 2) & (csize - 1)) == rank) {
    const int g = static_cast<int>(start >> 2) >> logc;
    if (g >= gb && g < ge) {
      nf = 1;
      if (lane == 0) wlist[0] = static_cast<uint16_t>(start);
    }
  }
  __syncthreads();
  if (kCluster) cluster.barrier_wait();

  for (int lvl = 0;; ++lvl) {
    int* acc_cur = acc + (lvl & 1) * words;
    if (vec)
      push_rows<float4, kCluster>(cluster, a, n, wlist, nf, acc_cur, logc, lane);
    else
      push_rows<float, kCluster>(cluster, a, n, wlist, nf, acc_cur, logc, lane);
    // the level's one barrier: every push is in, every stamp of lvl too
    if (kCluster) cluster.sync(); else __syncthreads();
    if (live[0] < lvl) break;                         // the frontier was empty
    // my columns' sums (then zeroed for level lvl + 2); new nodes into the
    // warp's list
    nf = 0;
    for (int g0 = gb; g0 < ge; g0 += 32) {            // the same trips for the warp
      const int g = g0 + lane;
      unsigned found = 0;
      if (g < ge) {
        int* cell = acc_cur + (g >> 5) * 128 + (g & 31);
        const int4 sum = make_int4(cell[0], cell[32], cell[64], cell[96]);
        if (sum.x | sum.y | sum.z | sum.w) {
          cell[0] = cell[32] = cell[64] = cell[96] = 0;
          short4* dq = reinterpret_cast<short4*>(dist) + g;
          short4 d = *dq;
          const short up = static_cast<short>(lvl + 1);
          if (sum.x > 0 && d.x == -1) d.x = up, found |= 1u;
          if (sum.y > 0 && d.y == -1) d.y = up, found |= 2u;
          if (sum.z > 0 && d.z == -1) d.z = up, found |= 4u;
          if (sum.w > 0 && d.w == -1) d.w = up, found |= 8u;
          if (found) *dq = d;
        }
      }
      if (__ballot_sync(KFULL, found) == 0) continue;
      const unsigned below = (1u << lane) - 1u;
      const int col0 = 4 * (g * csize + rank);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned bal = __ballot_sync(KFULL, (found >> c) & 1u);
        if ((found >> c) & 1u)
          wlist[nf + __popc(bal & below)] = static_cast<uint16_t>(col0 + c);
        nf += __popc(bal);
      }
    }
    __syncwarp();
    if (nf > 0 && lane < csize)                       // level lvl + 1 is live
      (kCluster ? cluster.map_shared_rank(live, lane) : live)[0] = lvl + 1;
  }

  int64_t* o = out + static_cast<size_t>(bs) * n;
  for (int t = tid; t < 4 * groups; t += KTHREADS) {
    const int col = 4 * ((t >> 2) * csize + rank) + (t & 3);
    if (col < n) o[col] = max(static_cast<int>(dist[t]), -1);
  }
}

template <bool kCluster>
int launch(const void* adj, const void* mask, const void* starts, void* out, int b,
           int n, int s, int cluster, int width, void* stream) {
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        bfs_kernel<kCluster>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(KMAX_N));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * s * cluster);
  cfg.blockDim = dim3(KTHREADS);
  cfg.dynamicSmemBytes = smem_bytes(width);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, bfs_kernel<kCluster>, static_cast<const float*>(adj),
      static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(starts),
      static_cast<int64_t*>(out), n, s, width);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches B * S clusters of `cluster` CTAs of KTHREADS threads on
// `stream` (plain CTAs where `cluster` is 1), each CTA owning `width`
// columns, with smem_bytes(n, width) of dynamic shared memory
// (shadow_gnn_torch/ops/bfs.py:launch_dims).  The first call of each form
// raises its shared-memory limit to what KMAX_N needs (before any capture:
// a step's first run is eager).  Returns the launch's CUDA error (0 =
// launched; cudaErrorInvalidValue for a shape the kernel does not take).
int bfs_hops_launch(const void* adj, const void* mask, const void* starts, void* out,
                    int b, int n, int s, int cluster, int width, void* stream) {
  const bool ok_cluster = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
  if (b < 1 || n < 1 || n > KMAX_N || s < 1 || !ok_cluster || width < 4 ||
      width != 4 * (((n + 3) / 4 + cluster - 1) / cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster == 1 ? launch<false>(adj, mask, starts, out, b, n, s, 1, width, stream)
                      : launch<true>(adj, mask, starts, out, b, n, s, cluster, width,
                                     stream);
}

}  // extern "C"
