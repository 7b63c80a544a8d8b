// Device helpers shared by K2 (warp_trilerp_cached.cu), K3
// (warp_trilerp_bricks.cu), K4 (trilerp_bricks.cu) and K6
// (trilerp_ablation.cu): the dual-quaternion
// normalization and sandwich of ops/compwise.py, and the trilerp of
// ops/interp.py:trilinear_c (the JAX package's models/warp_field.py:
// _trilinear_c), each in its PyTorch twin's operation order so that, with
// -fmad=false and IEEE sqrt/division, the kernels round as the twins do;
// and the asynchronous copies and warp reductions of K2's and K3's
// brick pipelines.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

// Components 1-3 of the Hamilton product a.b, each in quat_mul_c's order
// (ops/compwise.py).
__device__ __forceinline__ void quat_mul_xyz(const float* a, const float* b,
                                             float* o) {
  o[0] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[1] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[2] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// (q . v . conj(q))[5:8] with v = (1,0,0,0, 0,p): the twin's
// dq_mul_c(dq_mul_c(q, v), dq_conj_full_c(q)) (ops/compwise.py:dq_point_c)
// with every product by one of v's literal zeros and ones dropped and only
// components 5-7 of the outer product formed: 69 operations instead of
// 176. The terms that remain are added in the twin's order, so for finite
// inputs the result is the twin's exactly: a dropped x*0 is a signed zero,
// adding it to a nonzero sum changes nothing and to a zero sum at most the
// zero's sign, and x*1 is x.
__device__ __forceinline__ void dq_point(const float* q, float& px,
                                         float& py, float& pz) {
  // t = q.v: t[0:4] = q[0:4];
  // t[4+i] = (q[0:4].(0,p))[i] + (q[4:8].(1,0,0,0))[i]
  const float td[4] = {
      ((-(q[1] * px)) - q[2] * py) - q[3] * pz + q[4],
      (q[0] * px + q[2] * pz) - q[3] * py + q[5],
      (q[0] * py - q[1] * pz) + q[3] * px + q[6],
      (q[0] * pz + q[1] * py) - q[2] * px + q[7],
  };
  // (t.conj(q))[5:8] = (t[0:4].conj(q)[4:8] + t[4:8].conj(q)[0:4])[1:4]
  const float cr[4] = {q[0], -q[1], -q[2], -q[3]};
  const float cd[4] = {-q[4], q[5], q[6], q[7]};
  float r1[3], r2[3];
  quat_mul_xyz(q, cd, r1);
  quat_mul_xyz(td, cr, r2);
  px = r1[0] + r2[0];
  py = r1[1] + r2[1];
  pz = r1[2] + r2[2];
}

// 8-norm normalization of a blended DQ; an underflowed norm (squared norm
// below the smallest normal float, ops/dualquat.py:NORM2_MIN) takes the
// identity, as XLA's subnormal flush does in the JAX package.
__device__ __forceinline__ void dq_normalize8(const float* acc, float* se3) {
  float n2 = acc[0] * acc[0];
  for (int e = 1; e < 8; ++e) n2 = n2 + acc[e] * acc[e];
  const float n = sqrtf(n2);
  const bool ok = n2 >= FLT_MIN;
  const float inv = ok ? 1.f / n : 0.f;
  se3[0] = ok ? acc[0] * inv : 1.f;
  for (int e = 1; e < 8; ++e) se3[e] = ok ? acc[e] * inv : 0.f;
}

// Inside [0, r-1] on every axis of the live volume (reference
// core/util.py:107-108).
__device__ __forceinline__ bool in_volume(float px, float py, float pz,
                                          int rx, int ry, int rz) {
  return px >= 0.f && px <= rx - 1.f && py >= 0.f && py <= ry - 1.f &&
         pz >= 0.f && pz <= rz - 1.f;
}

// The index step of the trilerp of live (rx, ry, rz) at p: clip, floor,
// x1 = min(x0+1, r-1), fractions.
struct TrilerpIdx {
  int x0, x1, y0, y1, z0, z1;
  float xd, yd, zd;
};

__device__ __forceinline__ TrilerpIdx trilerp_index(int rx, int ry, int rz,
                                                    float px, float py,
                                                    float pz) {
  const float fx = fminf(fmaxf(px, 0.f), rx - 1.f);
  const float fy = fminf(fmaxf(py, 0.f), ry - 1.f);
  const float fz = fminf(fmaxf(pz, 0.f), rz - 1.f);
  TrilerpIdx t;
  t.x0 = (int)floorf(fx);
  t.y0 = (int)floorf(fy);
  t.z0 = (int)floorf(fz);
  t.x1 = min(t.x0 + 1, rx - 1);
  t.y1 = min(t.y0 + 1, ry - 1);
  t.z1 = min(t.z0 + 1, rz - 1);
  t.xd = fx - (float)t.x0;
  t.yd = fy - (float)t.y0;
  t.zd = fz - (float)t.z0;
  return t;
}

// One tap of live, straight from global memory through the read-only
// cache.
__device__ __forceinline__ float trilerp_tap(const float* __restrict__ live,
                                             int ry, int rz, int ix, int iy,
                                             int iz) {
  return __ldg(live + ((int64_t)ix * ry + iy) * rz + iz);
}

// The lerp step: x then y then z over the 8 taps of an index step.
__device__ __forceinline__ float trilerp_lerp(const float* __restrict__ live,
                                              int ry, int rz,
                                              const TrilerpIdx& t) {
  auto g = [&](int ix, int iy, int iz) {
    return trilerp_tap(live, ry, rz, ix, iy, iz);
  };
  const int x0 = t.x0, x1 = t.x1, y0 = t.y0, y1 = t.y1, z0 = t.z0,
            z1 = t.z1;
  const float xd = t.xd, yd = t.yd, zd = t.zd;
  const float c00 = g(x0, y0, z0) * (1.f - xd) + g(x1, y0, z0) * xd;
  const float c01 = g(x0, y1, z0) * (1.f - xd) + g(x1, y1, z0) * xd;
  const float c10 = g(x0, y0, z1) * (1.f - xd) + g(x1, y0, z1) * xd;
  const float c11 = g(x0, y1, z1) * (1.f - xd) + g(x1, y1, z1) * xd;
  const float c0 = c00 * (1.f - yd) + c01 * yd;
  const float c1 = c10 * (1.f - yd) + c11 * yd;
  return c0 * (1.f - zd) + c1 * zd;
}

// Trilerp of live (rx, ry, rz) at p: the index step, then the lerp step.
__device__ __forceinline__ float trilerp_c(const float* __restrict__ live,
                                           int rx, int ry, int rz, float px,
                                           float py, float pz) {
  return trilerp_lerp(live, ry, rz, trilerp_index(rx, ry, rz, px, py, pz));
}

// trilerp_c for a live volume of fewer than 2^31 cells, for K2 and K3: the
// same 8 taps and the same lerp order (so the same value), addressed by
// 32-bit offsets from one base pointer instead of a 64-bit index a tap,
// which takes fewer registers and instructions.
__device__ __forceinline__ float trilerp_c32(const float* __restrict__ live,
                                             int rx, int ry, int rz,
                                             float px, float py, float pz) {
  const TrilerpIdx t = trilerp_index(rx, ry, rz, px, py, pz);
  const int sx = ry * rz;
  const float* __restrict__ p = live + (t.x0 * sx + t.y0 * rz + t.z0);
  const int dx = (t.x1 - t.x0) * sx, dy = (t.y1 - t.y0) * rz,
            dz = t.z1 - t.z0;
  const float xd = t.xd, yd = t.yd, zd = t.zd;
  const float c00 = __ldg(p) * (1.f - xd) + __ldg(p + dx) * xd;
  const float c01 = __ldg(p + dy) * (1.f - xd) + __ldg(p + dx + dy) * xd;
  const float c10 = __ldg(p + dz) * (1.f - xd) + __ldg(p + dx + dz) * xd;
  const float c11 =
      __ldg(p + dy + dz) * (1.f - xd) + __ldg(p + dx + dy + dz) * xd;
  const float c0 = c00 * (1.f - yd) + c01 * yd;
  const float c1 = c10 * (1.f - yd) + c11 * yd;
  return c0 * (1.f - zd) + c1 * zd;
}

// ---- asynchronous global -> shared copies (sm_80+), one group per stage

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// dst and src 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for this thread's copies; a __syncthreads() after it makes every
// thread's copies visible to the block
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// brick b's candidate row (C ints) into s_cand: one 4-byte copy for each
// of threads 0..C-1, committed as one group
__device__ __forceinline__ void fetch_cand(int* s_cand, const int* cand,
                                           int b, int NB, int C) {
  const int i = threadIdx.x;
  if (b < NB && i < C) cp_async4(s_cand + i, cand + (int64_t)b * C + i);
  cp_async_commit();
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

// The CTA size of K2 and K3: each thread owns one voxel pair (2p, 2p+1),
// z-neighbours, of a brick of up to 512 voxels.
constexpr int kPairThreads = 256;

// The persistent grid of a brick kernel: as many CTAs as fit on the card at
// once (blocks per SM from the occupancy calculator, times the SMs), at most
// one per brick.
template <typename Kernel>
int persistent_grid(Kernel kernel, size_t smem, int n_bricks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kPairThreads, smem);
  const long long g = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  return (int)(g < n_bricks ? g : n_bricks);
}

// out: registers, local (spill) bytes per thread, threads per CTA, CTAs per
// SM, the persistent grid for an unbounded brick count, dynamic shared bytes
template <typename Kernel>
int kernel_info(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kPairThreads, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = kPairThreads;
  out[3] = per_sm;
  out[4] = persistent_grid(kernel, smem, 1 << 30);
  out[5] = (int)smem;
  return (int)cudaGetLastError();
}

}  // namespace
