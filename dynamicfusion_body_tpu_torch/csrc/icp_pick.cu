// K9: the rigid ICP's canonical warp and point-to-plane pick, over the
// counted rows.
//
// Replaces no TPU kernel: the JAX package's rigid ICP (and the port's CPU
// path) warps the canonical mesh by the one pose DQ and picks each row's
// correspondence in plain array code (ops/dualquat.py:dq_transform_point,
// dq_transform_normal; pipeline/correspondence.py:
// closest_point_correspondences_lattice, _pick). Two launches a search, on
// either side of K7 (knn_grid.cu):
//
// * icp_warp_kernel moves the first n_verts canonical vertices by the DQ,
//   the queries K7 searches with. Rows past n_verts are not written: K7
//   gives them (+inf, 0) whatever they hold.
// * icp_pick_kernel takes K7's (dists, idx) for every row: the k live
//   candidates, each with the point-to-plane cost |n.(v - p)| of the warped
//   normal (rotated here, in registers) or +inf where K7 found none; the
//   first least cost, a NaN before any number as torch.argmin orders them;
//   that candidate where its cost is below 1, else candidate 0 and cost 1;
//   valid where the row is counted, the cost within tolerance and
//   candidate 0 found.
//
// Both evaluate the plain composition's float32 expression tree as it
// stands, so their outputs equal its outputs on the card bit for bit: the
// sandwich dq . v . conj(dq) with v = (1,0,0,0, 0,p) and every product by
// v's zeros and ones kept (a signed zero or a NaN passes through as it
// does there), each Hamilton product's component left to right, the dual
// part qm(ar, bd) + qm(ad, br), the conjugate as the product by its sign
// vector, and the cost's three terms summed in the order of torch.sum's
// CUDA reduction over a last axis of 3 (two threads a row: (t0 + t2) + t1;
// tools/profile_icp_pick.py checks the order on the card). The
// intrinsics round each operation on its own, whatever the flags.
//
// Bound on this card: memory. The warp reads and writes 12 bytes a counted
// row. The pick reads each row's k slots (4 + 8 bytes each) and writes 17
// bytes a row (corr, valid, cost); a counted row with a candidate also
// reads its warped vertex and normal (24 bytes) and the k candidates it
// found (12 bytes each, gathered). The arithmetic, ~160 operations a
// sandwich, is far below the bytes' time. The DQ is read on the card (8
// floats) and the count too: no upload, no host read.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 8;  // ops/knn_grid_cuda.py:MAX_K

struct Quat {
  float w, x, y, z;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// ops/dualquat.py:quat_multiply, each component left to right.
__device__ __forceinline__ Quat qmul(Quat a, Quat b) {
  return {sub(sub(sub(mul(a.w, b.w), mul(a.x, b.x)), mul(a.y, b.y)),
              mul(a.z, b.z)),
          sub(add(add(mul(a.w, b.x), mul(a.x, b.w)), mul(a.y, b.z)),
              mul(a.z, b.y)),
          add(add(sub(mul(a.w, b.y), mul(a.x, b.z)), mul(a.y, b.w)),
              mul(a.z, b.x)),
          add(sub(add(mul(a.w, b.z), mul(a.x, b.y)), mul(a.y, b.x)),
              mul(a.z, b.w))};
}

__device__ __forceinline__ Quat qadd(Quat a, Quat b) {
  return {add(a.w, b.w), add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)};
}

// ops/dualquat.py:dq_transform_point of p by the DQ (r, d):
// (dq_multiply(dq_multiply(dq, v), dq_full_conjugate(dq)))[5:8].
__device__ __forceinline__ float3 sandwich(Quat r, Quat d, float3 p) {
  const Quat vr = {1.f, 0.f, 0.f, 0.f};
  const Quat vd = {0.f, p.x, p.y, p.z};
  const Quat tr = qmul(r, vr);
  const Quat td = qadd(qmul(r, vd), qmul(d, vr));
  const Quat cr = {mul(r.w, 1.f), mul(r.x, -1.f), mul(r.y, -1.f),
                   mul(r.z, -1.f)};
  const Quat cd = {mul(d.w, -1.f), mul(d.x, 1.f), mul(d.y, 1.f),
                   mul(d.z, 1.f)};
  const Quat od = qadd(qmul(tr, cd), qmul(td, cr));
  return make_float3(od.x, od.y, od.z);
}

__device__ __forceinline__ void load_dq(const float* __restrict__ dq, Quat& r,
                                        Quat& d) {
  r = {__ldg(dq), __ldg(dq + 1), __ldg(dq + 2), __ldg(dq + 3)};
  d = {__ldg(dq + 4), __ldg(dq + 5), __ldg(dq + 6), __ldg(dq + 7)};
}

__device__ __forceinline__ float3 load3(const float* __restrict__ a,
                                        long long i) {
  return make_float3(a[3 * i], a[3 * i + 1], a[3 * i + 2]);
}

__global__ void __launch_bounds__(kThreads)
    icp_warp_kernel(const float* __restrict__ dq,
                    const float* __restrict__ verts,
                    const int* __restrict__ n_ptr, int V,
                    float* __restrict__ wv) {
  const int n = min(*n_ptr, V);
  Quat r, d;
  load_dq(dq, r, d);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float3 w = sandwich(r, d, load3(verts, i));
    wv[3 * (long long)i] = w.x;
    wv[3 * (long long)i + 1] = w.y;
    wv[3 * (long long)i + 2] = w.z;
  }
}

__global__ void __launch_bounds__(kThreads)
    icp_pick_kernel(const float* __restrict__ dq,
                    const float* __restrict__ wv,
                    const float* __restrict__ normals,
                    const int* __restrict__ n_ptr, int V,
                    const float* __restrict__ live,
                    const float* __restrict__ dists,
                    const long long* __restrict__ idx, int k, float tolerance,
                    float* __restrict__ corr, bool* __restrict__ valid,
                    float* __restrict__ cost) {
  const int n = *n_ptr;
  Quat r, d;
  load_dq(dq, r, d);
  // dq_transform_normal rotates by (r, 0): torch.zeros_like's +0
  const Quat zero = {0.f, 0.f, 0.f, 0.f};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < V;
       i += gridDim.x * blockDim.x) {
    const float* di = dists + (long long)i * k;
    const long long* ii = idx + (long long)i * k;
    unsigned found = 0;  // bit j: K7 found candidate j
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < k && isfinite(di[j])) found |= 1u << j;
    float3 v = make_float3(0.f, 0.f, 0.f), wn = v;
    if (found) {
      v = load3(wv, i);
      wn = sandwich(r, zero, load3(normals, i));
    }
    int best = 0;
    float best_cost = INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j >= k) continue;
      float c = INFINITY;
      if (found & (1u << j)) {
        const float3 p = load3(live, ii[j]);
        const float t0 = mul(wn.x, sub(v.x, p.x));
        const float t1 = mul(wn.y, sub(v.y, p.y));
        const float t2 = mul(wn.z, sub(v.z, p.z));
        c = fabsf(add(add(t0, t2), t1));
      }
      // the first NaN, else the first least
      if (j == 0 || (!isnan(best_cost) && (isnan(c) || c < best_cost))) {
        best = j;
        best_cost = c;
      }
    }
    const bool use_min = best_cost < 1.f;
    const float3 p = load3(live, ii[use_min ? best : 0]);
    corr[3 * (long long)i] = p.x;
    corr[3 * (long long)i + 1] = p.y;
    corr[3 * (long long)i + 2] = p.z;
    const float c = use_min ? best_cost : 1.f;
    cost[i] = c;
    valid[i] = i < n && c <= tolerance && (found & 1u);
  }
}

int stream_grid(int n) {
  // enough CTAs to fill the card, each walking the rows grid-stride
  return (int)max(1LL, min((n + (long long)kThreads - 1) / kThreads,
                           132LL * 16));
}

}  // namespace

extern "C" int dfb_icp_warp(const float* dq, const float* verts,
                            const int* n_verts, int V, float* wv,
                            void* stream) {
  if (V < 1) return (int)cudaGetLastError();
  icp_warp_kernel<<<stream_grid(V), kThreads, 0, (cudaStream_t)stream>>>(
      dq, verts, n_verts, V, wv);
  return (int)cudaGetLastError();
}

extern "C" int dfb_icp_pick(const float* dq, const float* wv,
                            const float* normals, const int* n_verts, int V,
                            const float* live, const float* dists,
                            const long long* idx, int k, float tolerance,
                            float* corr, void* valid, float* cost,
                            void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (V < 1) return (int)cudaGetLastError();
  icp_pick_kernel<<<stream_grid(V), kThreads, 0, (cudaStream_t)stream>>>(
      dq, wv, normals, n_verts, V, live, dists, idx, k, tolerance, corr,
      (bool*)valid, cost);
  return (int)cudaGetLastError();
}

// out[6]: registers, local (spill) bytes per thread, threads per CTA, CTAs
// per SM, static shared bytes, 0 (no persistent grid) of the warp (which
// 0) or the pick (which 1)
extern "C" int dfb_icp_pick_info(int which, int* out) {
  const void* kernel = which == 0   ? (const void*)icp_warp_kernel
                       : which == 1 ? (const void*)icp_pick_kernel
                                    : nullptr;
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
