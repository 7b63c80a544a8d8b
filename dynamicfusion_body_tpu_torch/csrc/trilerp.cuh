// Device helpers shared by K2 (warp_trilerp_cached.cu), K3
// (warp_trilerp_bricks.cu), K4 (trilerp_bricks.cu) and K6
// (trilerp_ablation.cu): the dual-quaternion
// normalization and sandwich of ops/compwise.py, and the trilerp of
// ops/interp.py:trilinear_c (the JAX package's models/warp_field.py:
// _trilinear_c), each in its PyTorch twin's operation order so that, with
// -fmad=false and IEEE sqrt/division, the kernels round as the twins do.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void quat_mul(const float* a, const float* b,
                                         float* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

__device__ __forceinline__ void dq_mul(const float* a, const float* b,
                                       float* o) {
  float rd1[4], rd2[4];
  quat_mul(a, b, o);
  quat_mul(a, b + 4, rd1);
  quat_mul(a + 4, b, rd2);
  for (int i = 0; i < 4; ++i) o[4 + i] = rd1[i] + rd2[i];
}

// (dq . v . conj(dq))[5:8] with v = (1,0,0,0, 0,p)
__device__ __forceinline__ void dq_point(const float* dq, float& px,
                                         float& py, float& pz) {
  const float v[8] = {1.f, 0.f, 0.f, 0.f, 0.f, px, py, pz};
  const float c[8] = {dq[0], -dq[1], -dq[2], -dq[3],
                      -dq[4], dq[5], dq[6], dq[7]};
  float t[8], o[8];
  dq_mul(dq, v, t);
  dq_mul(t, c, o);
  px = o[5];
  py = o[6];
  pz = o[7];
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

}  // namespace
