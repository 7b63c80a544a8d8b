// K7: exact k-nearest-neighbour search on the voxel lattice.
//
// Replaces no TPU kernel: the JAX package searches its rigid ICP's closest
// points with the flat search (ops/knn.py:knn, every query against every
// point slot). At 512^3 one view's mesh holds millions of vertices, and a
// flat search of one such mesh against another is ~10^13 pairs; the ICP
// branch runs 21 of them a capture. This search does the same job exactly:
// for each valid query row, the k valid points nearest by the float32
// squared distance (dx*dx + dy*dy) + dz*dz, ascending, equal distances to
// the lower point index; sqrt of it out. Rows past the query count, and
// queries that are not finite, get (+inf, 0) in every slot, as do the
// slots of a query left without k points.
//
// Structure: the points are counted into cubic cells of `cell` voxels on
// a 2^L-a-side grid (clamped at its faces), numbered in Morton order, so
// that each node of the implicit octree over the cells (a cell block of
// 2^l a side) owns one contiguous range of the cell-sorted points:
// off[prefix << 3l] .. off[(prefix + 1) << 3l]. Three launches a search:
// knn_grid_bin_kernel (cell code and rank within the cell, by atomics),
// the exclusive sum of the counts (PyTorch, in the wrapper), and
// knn_grid_scatter_kernel (the points as float4 (x, y, z, index bits) in
// cell order; the order inside a cell is the atomics' and matters to
// nothing, since ties are broken by index). K7 proper is
// knn_grid_query_kernel: one thread a query walks the octree depth first,
// nearest child first, from a stack in local memory, keeping its k best
// in registers; a node is skipped when the squared distance from the
// query to its box exceeds the current k-th. Each box is exact in float32
// (its faces are multiples of the power-of-two cell) and rounding is
// monotone, so a skipped node holds no point nearer than, or as near as,
// the k-th: the result is the exhaustive search's. Boxes of nodes on the
// grid's faces reach to infinity outward (the clamped points).
//
// Bound on this card: memory. Each query and point is read once and each
// output written once: 12 bytes a query and a point, 8 + 4 bytes a slot.
// What the search reads on top (the visited nodes' offsets, the leaves'
// points) is its own cost; far queries (most of a view's mesh lies tens of
// voxels from another view's) visit more of the tree.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLevels = 9;                 // grid <= 512 cells a side
constexpr int kStack = 7 * kMaxLevels + 2;    // DFS stack entries

// x, y, z bits of a cell interleaved as z2 y2 x2 z1 y1 x1 z0 y0 x0
__device__ __forceinline__ uint32_t spread3(uint32_t v) {
  v &= 0x3ff;
  v = (v | (v << 16)) & 0x030000ff;
  v = (v | (v << 8)) & 0x0300f00f;
  v = (v | (v << 4)) & 0x030c30c3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ __forceinline__ uint32_t compact3(uint32_t v) {
  v &= 0x09249249;
  v = (v | (v >> 2)) & 0x030c30c3;
  v = (v | (v >> 4)) & 0x0300f00f;
  v = (v | (v >> 8)) & 0x030000ff;
  v = (v | (v >> 16)) & 0x3ff;
  return v;
}

__device__ __forceinline__ int cell_of(float x, float inv_cell, int G) {
  // clamped in float first: a NaN or a huge coordinate lands on a face
  const float c = fminf(fmaxf(floorf(x * inv_cell), 0.0f), (float)(G - 1));
  return (int)c;
}

// distance from q to [lo, hi) along one axis, the faces of the grid open
__device__ __forceinline__ float axis_gap(float q, int c0, int c1, int G,
                                          float cell) {
  const float lo = (float)c0 * cell;
  const float hi = (float)c1 * cell;
  if (c0 > 0 && q < lo) return lo - q;
  if (c1 < G && q > hi) return q - hi;
  return 0.0f;
}

__device__ __forceinline__ float box_d2(float qx, float qy, float qz,
                                        uint32_t prefix, int lev, int G,
                                        float cell) {
  const int s = 1 << lev;
  const int x0 = (int)compact3(prefix) << lev;
  const int y0 = (int)compact3(prefix >> 1) << lev;
  const int z0 = (int)compact3(prefix >> 2) << lev;
  const float dx = axis_gap(qx, x0, x0 + s, G, cell);
  const float dy = axis_gap(qy, y0, y0 + s, G, cell);
  const float dz = axis_gap(qz, z0, z0 + s, G, cell);
  float d2 = dx * dx;
  d2 = d2 + dy * dy;
  d2 = d2 + dz * dz;
  return d2;
}

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && (unsigned)i < (unsigned)bi);
}

template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int i) {
  if (!before(d, i, bd[K - 1], bi[K - 1])) return;
  bool placed = false;
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    if (!placed) {
      if (s > 0 && before(d, i, bd[s - 1], bi[s - 1])) {
        bd[s] = bd[s - 1];
        bi[s] = bi[s - 1];
      } else {
        bd[s] = d;
        bi[s] = i;
        placed = true;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_grid_bin_kernel(const float* __restrict__ pts,
                        const int* __restrict__ n_ptr, int P, int levels,
                        float inv_cell, int* __restrict__ cnt,
                        int* __restrict__ code, int* __restrict__ rank) {
  const int n = min(*n_ptr, P);
  const int G = 1 << levels;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint32_t m = spread3(cell_of(pts[3 * i], inv_cell, G)) |
                       (spread3(cell_of(pts[3 * i + 1], inv_cell, G)) << 1) |
                       (spread3(cell_of(pts[3 * i + 2], inv_cell, G)) << 2);
    code[i] = (int)m;
    rank[i] = atomicAdd(cnt + m, 1);
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_grid_scatter_kernel(const float* __restrict__ pts,
                            const int* __restrict__ n_ptr, int P,
                            const int* __restrict__ off,
                            const int* __restrict__ code,
                            const int* __restrict__ rank,
                            float4* __restrict__ sorted) {
  const int n = min(*n_ptr, P);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    sorted[off[code[i]] + rank[i]] =
        make_float4(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2],
                    __int_as_float(i));
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_grid_query_kernel(const float* __restrict__ q,
                          const int* __restrict__ nq_ptr, int Q,
                          const float4* __restrict__ sorted,
                          const int* __restrict__ off, int levels, float cell,
                          float* __restrict__ dist,
                          long long* __restrict__ idx) {
  const int nq = min(*nq_ptr, Q);
  const int G = 1 << levels;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= Q) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = -1;
  }
  const float qx = q[3 * row], qy = q[3 * row + 1], qz = q[3 * row + 2];
  if (row < nq && isfinite(qx) && isfinite(qy) && isfinite(qz)) {
    uint32_t stack[kStack];
    int sp = 0;
    stack[sp++] = (uint32_t)levels;  // the root: prefix 0
    while (sp > 0) {
      const uint32_t e = stack[--sp];
      const int lev = (int)(e & 15u);
      const uint32_t pre = e >> 4;
      if (box_d2(qx, qy, qz, pre, lev, G, cell) > bd[K - 1]) continue;
      if (lev == 0) {
        const int b = off[pre + 1];
        for (int t = off[pre]; t < b; ++t) {
          const float4 p = sorted[t];
          const float dx = qx - p.x, dy = qy - p.y, dz = qz - p.z;
          float d2 = dx * dx;
          d2 = d2 + dy * dy;
          d2 = d2 + dz * dz;
          insert<K>(bd, bi, d2, __float_as_int(p.w));
        }
        continue;
      }
      // the non-empty children within the k-th distance, pushed farthest
      // first so that the nearest is walked next
      const int sh = 3 * (lev - 1);
      int o[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) o[c] = off[(pre * 8u + (uint32_t)c) << sh];
      float cd[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t child = pre * 8u + (uint32_t)c;
        cd[c] = -1.0f;
        if (o[c] != o[c + 1]) {
          const float d = box_d2(qx, qy, qz, child, lev - 1, G, cell);
          if (!(d > bd[K - 1])) cd[c] = d;
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        int far = -1;
        float fd = -1.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (cd[c] > fd) {
            fd = cd[c];
            far = c;
          }
        }
        if (far >= 0) {
          stack[sp++] = ((pre * 8u + (uint32_t)far) << 4) | (uint32_t)(lev - 1);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (c == far) cd[c] = -1.0f;
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    dist[(long long)row * K + s] = sqrtf(bd[s]);
    idx[(long long)row * K + s] = bi[s] < 0 ? 0 : bi[s];
  }
}

using Query = void (*)(const float*, const int*, int, const float4*,
                       const int*, int, float, float*, long long*);

constexpr int kMaxK = 8;

Query query_at(int k) {
  switch (k) {
    case 1: return knn_grid_query_kernel<1>;
    case 2: return knn_grid_query_kernel<2>;
    case 3: return knn_grid_query_kernel<3>;
    case 4: return knn_grid_query_kernel<4>;
    case 5: return knn_grid_query_kernel<5>;
    case 6: return knn_grid_query_kernel<6>;
    case 7: return knn_grid_query_kernel<7>;
    case 8: return knn_grid_query_kernel<8>;
    default: return nullptr;
  }
}

int stream_grid(int n) {
  // enough CTAs to fill the card, each walking the rows grid-stride
  return max(1, min((n + kThreads - 1) / kThreads, 132 * 16));
}

}  // namespace

extern "C" int dfb_knn_grid_bin(const float* pts, const int* n_pts, int P,
                                int levels, float inv_cell, int* cnt,
                                int* code, int* rank, void* stream) {
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (P < 1) return (int)cudaGetLastError();
  knn_grid_bin_kernel<<<stream_grid(P), kThreads, 0, (cudaStream_t)stream>>>(
      pts, n_pts, P, levels, inv_cell, cnt, code, rank);
  return (int)cudaGetLastError();
}

extern "C" int dfb_knn_grid_scatter(const float* pts, const int* n_pts, int P,
                                    const int* off, const int* code,
                                    const int* rank, void* sorted,
                                    void* stream) {
  if (P < 1) return (int)cudaGetLastError();
  knn_grid_scatter_kernel<<<stream_grid(P), kThreads, 0,
                            (cudaStream_t)stream>>>(
      pts, n_pts, P, off, code, rank, (float4*)sorted);
  return (int)cudaGetLastError();
}

extern "C" int dfb_knn_grid_query(const float* q, const int* n_q, int Q,
                                  const void* sorted, const int* off,
                                  int levels, float cell, int k, float* dist,
                                  long long* idx, void* stream) {
  const Query kernel = query_at(k);
  if (kernel == nullptr || levels < 1 || levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  if (Q < 1) return (int)cudaGetLastError();
  kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      q, n_q, Q, (const float4*)sorted, off, levels, cell, dist, idx);
  return (int)cudaGetLastError();
}

// out[6]: registers, local (stack) bytes per thread, threads per CTA, CTAs
// per SM, static shared bytes, 0 (no persistent grid) of the query kernel
// for k
extern "C" int dfb_knn_grid_query_info(int k, int* out) {
  const Query kernel = query_at(k);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = kThreads;
  out[3] = per_sm;
  out[4] = (int)a.sharedSizeBytes;
  out[5] = 0;
  return (int)cudaGetLastError();
}
