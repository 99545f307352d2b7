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
// valid j whose sum over the frontier rows, sum_i adj[i, j], is > 0: the
// plain version's bmm(frontier, adj) > 0.  The blocks hold small integers
// (0/1 edges, self edges, and the link task's target-edge removal), so
// the f32 sum is exact in any order and the kernel equals the plain
// version bit for bit.
//
// Not a TPU kernel's port: the counterpart of the JAX package's device
// loop (shadow_gnn_tpu/sampling/induction.py: bfs_hops_multi, a
// lax.while_loop).  The plain version's loop bound is a host read of the
// frontier at every level; here the loop runs on the device until the
// frontier is empty, so a CUDA graph can hold the whole BFS as one launch.
//
// Design.  One CTA per (subgraph, source), KTHREADS threads.  The
// distances (int32) and two frontier lists (u16 node indices: the current
// level's and the next's) live in shared memory, 8 N bytes.  Thread t
// owns the columns j = t, t + KTHREADS, ...; for each unvisited valid
// column it sums adj[i, j] over the frontier rows i, so the threads of a
// warp read neighbouring addresses of one row.  A column that is reached
// takes a slot of the next list (a shared atomic: the list's order varies,
// the sums do not).  Each row is read only while its node is on the
// frontier, at most once per source.
//
// What bounds it: the bytes.  A source needs the rows of the nodes it
// reaches, N * 4 bytes each, the mask and its output row (N * 8 bytes);
// it does no arithmetic to speak of.  A level costs two barriers, so a
// long chain (N - 1 levels) is bound by the barriers' latency, not by the
// bytes; PPR and k-hop subgraphs span a few levels.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KTHREADS = 256;
constexpr int KMAX_N = 16384;          // u16 lists; 8 N bytes of shared memory

__global__ void __launch_bounds__(KTHREADS)
bfs_kernel(const float* __restrict__ adj, const uint8_t* __restrict__ mask,
           const int64_t* __restrict__ starts, int64_t* __restrict__ out, int n,
           int s) {
  extern __shared__ int smem[];
  int* dist = smem;                                              // [n]
  uint16_t* lists = reinterpret_cast<uint16_t*>(smem + n);       // [2][n]
  __shared__ int count[2];

  const int tid = threadIdx.x;
  const int bs = blockIdx.x;                   // b * s + source
  const int b = bs / s;
  const float* a = adj + static_cast<size_t>(b) * n * n;
  const uint8_t* m = mask + static_cast<size_t>(b) * n;
  const int64_t start = starts[bs];
  const bool start_in = start >= 0 && start < n;

  for (int j = tid; j < n; j += KTHREADS) dist[j] = (j == start) ? 0 : -1;
  if (tid == 0) {
    count[0] = start_in ? 1 : 0;
    count[1] = 0;
    if (start_in) lists[0] = static_cast<uint16_t>(start);
  }
  __syncthreads();

  int cur = 0;
  int lvl = 0;
  while (count[cur] > 0) {
    const int nf = count[cur];
    const uint16_t* front = lists + cur * n;
    uint16_t* next = lists + (cur ^ 1) * n;
    for (int j = tid; j < n; j += KTHREADS) {
      if (dist[j] >= 0 || !m[j]) continue;
      float sum = 0.f;
      for (int k = 0; k < nf; ++k) sum += a[static_cast<size_t>(front[k]) * n + j];
      if (sum > 0.f) {
        dist[j] = lvl + 1;
        next[atomicAdd(&count[cur ^ 1], 1)] = static_cast<uint16_t>(j);
      }
    }
    __syncthreads();
    if (tid == 0) count[cur] = 0;
    cur ^= 1;
    ++lvl;
    __syncthreads();
  }

  int64_t* o = out + static_cast<size_t>(bs) * n;
  for (int j = tid; j < n; j += KTHREADS) o[j] = dist[j];
}

}  // namespace

extern "C" {

// Launches one CTA of KTHREADS threads per (subgraph, source) on
// `stream`, with 8 n bytes of dynamic shared memory; the first call
// raises the kernel's shared-memory limit to what KMAX_N needs (before
// any capture: a step's first run is eager).  Returns the launch's CUDA
// error (0 = launched).
int bfs_hops_launch(const void* adj, const void* mask, const void* starts, void* out,
                    int b, int n, int s, void* stream) {
  static bool raised = false;
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        bfs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 8 * KMAX_N);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  if (n < 1 || n > KMAX_N || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  bfs_kernel<<<b * s, KTHREADS, 8 * n, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(adj), static_cast<const uint8_t*>(mask),
      static_cast<const int64_t*>(starts), static_cast<int64_t*>(out), n, s);
  return static_cast<int>(cudaGetLastError());
}

int bfs_hops_threads() { return KTHREADS; }
int bfs_hops_max_n() { return KMAX_N; }

}  // extern "C"
