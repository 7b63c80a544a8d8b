// K5: multi-view projective depth fusion.
//
// Replaces the TPU kernel
// dynamicfusion_body_tpu/ops/fusion_pallas.py:fuse_depth_multi_bricks
// (pallas_call body _kernel). It computes the sequential spec, not the TPU's
// mechanism: models/tsdf_volume.py:fuse_depth applied view after view. Per
// voxel (i,j,k) of a dense (X,Y,Z) volume and per view, in view order:
// project through that view's 3x4 matrix proj = K·lw·IND, test that the
// pixel lies in [0, w-1) x [0, h-1), take the 4-tap bilinear sample of the
// negative depth map, turn it into a signed distance along the camera ray
// with row 2 of K^-1 (-tdist where the depth is missing or too close),
// and apply the running average with the WMAX clamp where dz < tdist.
//
// Bound on this card: each voxel's value and weight are read once and
// written once for the whole sequence (4 x 4 B per voxel: 268 MB at 256^3),
// plus the depth stack (8.4 MB at 8 x 512^2), ~0.083 ms at 3.35 TB/s. The
// instructions bound it harder: built with -fmad=false and IEEE division, a
// voxel-view in the image issues two divisions, four taps and ~60 more
// instructions, and a third division where it updates (the smoke prints
// the SASS count and the issue time it implies).
// Design: a warp owns a tile of kTileX x kTileY x kTileZ voxels; each lane
// owns a run of kRun voxels along z of one (i,j) row and walks the tile's
// x-planes, with 16-byte streaming loads and stores of the run's values and
// weights where Z % 4 == 0. Per plane and view the lane forms the row's
// projection prefix p0*x + p1*y once and finishes each voxel's
// (prefix + p2*z) + p3: the twin's left-to-right order, so the sharing is
// exact. Before its walk the warp culls views: eight lanes a view evaluate
// the tile's 8 corners in double and skip the view only where no voxel of
// the tile can pass the twin's image test (cull_views, with its proof); inside
// a tile the per-voxel test is exactly the twin's. The projections, K^-1's
// row 2 and the warps' cull bits sit in shared memory; the depth taps come
// through the read-only path and stay L2-resident (the whole stack is
// 8.4 MB of the 50 MB L2; the volume streams past it with evict-first
// hints). All index math is 32-bit: the wrapper refuses volumes and depth
// stacks of 2^31 elements or more.
// Evaluated with -fmad=false in the twin's operation order, with IEEE
// division, so it is bit-equal to fuse_depth applied view by view.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRun = 4;                  // voxels along z per lane
constexpr int kLanesZ = 8;               // a warp's lanes along z
constexpr int kTileY = 32 / kLanesZ;     // and along y
constexpr int kTileZ = kLanesZ * kRun;   // a warp's tile: 32 z
constexpr int kTileX = 8;                //   x 4 y x 8 x-planes
constexpr int kWarpsY = 2, kWarpsZ = 4;  // a CTA: 2 x 4 warp tiles
constexpr int kWarps = kWarpsY * kWarpsZ;
constexpr int kThreads = 32 * kWarps;
// CTAs a SM must hold: 64 registers a thread at most, 32 warps. The
// kernel is issue-bound, so more CTAs did not pay; at 5 or 6 an
// instantiation spills.
constexpr int kMinCtas = 4;
// 8 x 2^-24, above the bound 5 x 2^-24 / (1 - 5 x 2^-24) on the error of
// the f32 evaluation ((p0*x + p1*y) + p2*z) + p3 relative to the sum of its
// terms' magnitudes (five roundings at most)
constexpr double kRoundMargin = 1.0 / (1 << 21);

// The warp's cull of views c0 .. c0+31: bit b of the result set when no
// voxel of the box [i0,i1] x [j0,j1] x [k0,k1] can pass the twin's image
// test for view c0 + b. Four views at a time, eight lanes a view, one lane
// a corner; every lane of the warp calls it (shuffles and ballots).
//
// Proof. Let u, v, pw be the exact affine rows at a voxel and uf, vf, pwf
// their f32 evaluations: |uf - u| <= Eu = kRoundMargin * (|p0| i1 +
// |p1| j1 + |p2| k1 + |p3|) over the box, likewise Ev and Ew. The twin
// admits a voxel where px = fl(uf / pwf) lies in [0, w-1) and
// py = fl(vf / pwf) in [0, h-1). Rounding is monotone and w-1 is a float,
// so an admitted voxel has uf / pwf in (-1, w-1) and vf / pwf in
// (-1, h-1): a margin of one pixel below, which also covers a negative
// quotient rounded to -0. Where pwf > 0 that reads g1 = u + pw,
// g2 = w pw - u, g3 = v + pw, g4 = h pw - v, each > -E_i at the voxel
// (E1 = Eu + Ew, E2 = Eu + w Ew, E3 = Ev + Ew, E4 = Ev + h Ew); where
// pwf < 0 the inequalities flip: each g_i < E_i. The g_i are affine, so
// over the box they take their extremes at the 8 corners, which are
// voxels. So:
//  - pw > Ew at every corner (pwf > 0 on the whole box): skip when some g_i
//    is below -E_i at all 8 corners;
//  - pw < -Ew at every corner (pwf < 0 on the whole box, a camera looking
//    away, whose negative quotients the twin still tests): skip when some
//    g_i is above E_i at all 8 corners, i.e. -g_i below -E_i;
//  - otherwise pw may change sign inside the box: never skip.
// The corners are evaluated in double: each product of an f32 entry and
// an index below 2^24 is exact, and the sums' rounding is ~2^-53 of the
// terms, far inside kRoundMargin. ops/fusion_cuda.py:fuse_cull_tiles is
// the same function in PyTorch, operation for operation.
__device__ uint32_t cull_views(const float* sp, int c0, int n_views, int i0,
                               int i1, int j0, int j1, int k0, int k1, int h,
                               int w, int lane) {
  const int c = lane & 7;
  const double x = (c & 1) ? i1 : i0;
  const double y = (c & 2) ? j1 : j0;
  const double z = (c & 4) ? k1 : k0;
  const double dw = (double)w, dh = (double)h;
  uint32_t mask = 0;
  for (int v4 = 0; v4 < 32 && c0 + v4 < n_views; v4 += 4) {
    const int view = min(c0 + v4 + (lane >> 3), n_views - 1);
    const float* p = sp + view * 12;
    double e[3], t[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* q = p + 4 * r;
      e[r] = (((fabs((double)q[0]) * i1 + fabs((double)q[1]) * j1) +
               fabs((double)q[2]) * k1) + fabs((double)q[3])) * kRoundMargin;
      t[r] = (((double)q[0] * x + (double)q[1] * y) + (double)q[2] * z) +
             (double)q[3];
    }
    double wmin = t[2], wmax = t[2];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      wmin = fmin(wmin, __shfl_xor_sync(0xffffffffu, wmin, off));
      wmax = fmax(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
    }
    // +1: pwf > 0 on the box, -1: pwf < 0 on the box, 0: keep the view
    const double s = wmin > e[2] ? 1.0 : wmax < -e[2] ? -1.0 : 0.0;
    double g[4] = {s * (t[0] + t[2]), s * (dw * t[2] - t[0]),
                   s * (t[1] + t[2]), s * (dh * t[2] - t[1])};
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        g[a] = fmax(g[a], __shfl_xor_sync(0xffffffffu, g[a], off));
      }
    }
    const bool skip = s != 0.0 &&
        (g[0] < -(e[0] + e[2]) || g[1] < -(e[0] + dw * e[2]) ||
         g[2] < -(e[1] + e[2]) || g[3] < -(e[1] + dh * e[2]));
    const uint32_t b = __ballot_sync(0xffffffffu, skip && c == 0);
#pragma unroll
    for (int q = 0; q < 4; ++q) mask |= ((b >> (8 * q)) & 1u) << (v4 + q);
  }
  return c0 + 32 < n_views ? mask : mask & (0xffffffffu >> (c0 + 32 - n_views));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinCtas) fuse_depth_multi_kernel(
    const float* __restrict__ vals_in, const float* __restrict__ wts_in,
    const float* __restrict__ depths, const float* __restrict__ projs,
    const float* __restrict__ kinv_row2, int n_views, int h, int w, int X,
    int Y, int Z, float tdist, float wmax, float* __restrict__ vals_out,
    float* __restrict__ wts_out, uint8_t* __restrict__ cull_out) {
  // n_views x 12 projection entries (three float4 a view), K^-1's row 2
  // and a pad, then each warp's cull bits (one bit a view)
  extern __shared__ float4 smem[];
  float* sp = reinterpret_cast<float*>(smem);
  const int n12 = n_views * 12;
  for (int t = threadIdx.x; t < n12 + 3; t += kThreads) {
    sp[t] = t < n12 ? projs[t] : kinv_row2[t - n12];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tz = blockIdx.x * kWarpsZ + warp % kWarpsZ;
  const int ty = blockIdx.y * kWarpsY + warp / kWarpsZ;
  const int tx = blockIdx.z;
  const int i0 = tx * kTileX, j0 = ty * kTileY, k0 = tz * kTileZ;
  if (j0 >= Y || k0 >= Z) return;
  const int i1 = min(i0 + kTileX, X) - 1;
  const int j1 = min(j0 + kTileY, Y) - 1;
  const int k1 = min(k0 + kTileZ, Z) - 1;

  const int words = (n_views + 31) >> 5;
  uint32_t* skip = reinterpret_cast<uint32_t*>(sp + n12 + 4) + warp * words;
  for (int c0 = 0; c0 < n_views; c0 += 32) {
    const uint32_t mask =
        cull_views(sp, c0, n_views, i0, i1, j0, j1, k0, k1, h, w, lane);
    if (lane == 0) skip[c0 >> 5] = mask;
    if (cull_out != nullptr && c0 + lane < n_views) {
      const int n_tx = (X + kTileX - 1) / kTileX;
      const int n_ty = (Y + kTileY - 1) / kTileY;
      const int n_tz = (Z + kTileZ - 1) / kTileZ;
      cull_out[(((c0 + lane) * n_tx + tx) * n_ty + ty) * n_tz + tz] =
          (mask >> lane) & 1u;
    }
  }
  __syncwarp();

  const int j = j0 + lane / kLanesZ;
  const int k = k0 + (lane % kLanesZ) * kRun;
  if (j >= Y || k >= Z) return;
  const float ys = (float)j;
  const float kr0 = sp[n12], kr1 = sp[n12 + 1], kr2 = sp[n12 + 2];
  const float wlim = (float)(w - 1), hlim = (float)(h - 1);
  const int hw = h * w;

  for (int i = i0; i <= i1; ++i) {
    const int base = (i * Y + j) * Z + k;
    float val[kRun], wt[kRun];
    if (kVec) {  // Z % 4 == 0 and 16-byte aligned volumes
      const float4 v4 = __ldcs(reinterpret_cast<const float4*>(vals_in + base));
      const float4 w4 = __ldcs(reinterpret_cast<const float4*>(wts_in + base));
      val[0] = v4.x; val[1] = v4.y; val[2] = v4.z; val[3] = v4.w;
      wt[0] = w4.x; wt[1] = w4.y; wt[2] = w4.z; wt[3] = w4.w;
    } else {
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        val[r] = k + r < Z ? __ldcs(vals_in + base + r) : 0.0f;
        wt[r] = k + r < Z ? __ldcs(wts_in + base + r) : 0.0f;
      }
    }
    const float xs = (float)i;
    uint32_t culled = 0;  // the cull bits of views view & ~31 ..
    for (int view = 0; view < n_views; ++view) {
      if ((view & 31) == 0) culled = skip[view >> 5];
      if ((culled >> (view & 31)) & 1u) continue;
      const float4 pu = smem[3 * view], pv = smem[3 * view + 1],
                   pp = smem[3 * view + 2];
      // the twin's p0*x + p1*y + p2*z + p3 runs left to right, so the
      // prefix p0*x + p1*y is the whole run's
      const float au = pu.x * xs + pu.y * ys;
      const float av = pv.x * xs + pv.y * ys;
      const float aw = pp.x * xs + pp.y * ys;
      const int dmap = view * hw;
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (!kVec && k + r >= Z) break;
        const float zs = (float)(k + r);
        const float u = (au + pu.z * zs) + pu.w;
        const float pw = (aw + pp.z * zs) + pp.w;
        const float px = u / pw;
        // NaN and +-inf fail these tests, as in the twin
        if (!(px >= 0.0f && px < wlim)) continue;
        const float v = (av + pv.z * zs) + pv.w;
        const float py = v / pw;
        if (!(py >= 0.0f && py < hlim)) continue;

        const int x0 = (int)floorf(px);
        const int y0 = (int)floorf(py);
        const float wx = px - (float)x0;
        const float wy = py - (float)y0;
        const float* d = depths + (dmap + y0 * w + x0);
        const float up = __ldg(d) * (1.0f - wx) + __ldg(d + 1) * wx;
        const float bot = __ldg(d + w) * (1.0f - wx) + __ldg(d + w + 1) * wx;
        const float pz = -(up * (1.0f - wy) + bot * wy);
        const float dz = pz <= tdist
            ? -tdist
            : -(kr0 * (px * pz - u) + kr1 * (py * pz - v) + kr2 * (pz - pw));
        if (!(dz < tdist)) continue;
        const float nw = fminf(1.0f + wt[r], wmax);
        val[r] = ((nw - 1.0f) * val[r] + fmaxf(dz, -tdist)) / nw;
        wt[r] = nw;
      }
    }
    if (kVec) {
      __stcs(reinterpret_cast<float4*>(vals_out + base),
             make_float4(val[0], val[1], val[2], val[3]));
      __stcs(reinterpret_cast<float4*>(wts_out + base),
             make_float4(wt[0], wt[1], wt[2], wt[3]));
    } else {
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (k + r < Z) {
          __stcs(vals_out + base + r, val[r]);
          __stcs(wts_out + base + r, wt[r]);
        }
      }
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, int, int, int, int, int,
                        int, float, float, float*, float*, uint8_t*);

Kernel pick(bool vec) {
  return vec ? fuse_depth_multi_kernel<true> : fuse_depth_multi_kernel<false>;
}

size_t smem_bytes(int n_views) {
  return (size_t)(n_views * 12 + 4) * sizeof(float) +
         (size_t)kWarps * ((n_views + 31) / 32) * sizeof(uint32_t);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// cull_out (null on the fusion path): one byte per (view, warp tile), 1
// where the tile skipped the view, laid out (n_views, ceil(X/8),
// ceil(Y/4), ceil(Z/32)) as ops/fusion_cuda.py:fuse_cull_tiles returns it
extern "C" int dfb_fuse_depth_multi(const float* vals, const float* wts,
                                    const float* depths, const float* projs,
                                    const float* kinv_row2, int n_views,
                                    int h, int w, int X, int Y, int Z,
                                    float tdist, float wmax, float* vals_out,
                                    float* wts_out, uint8_t* cull_out,
                                    void* stream) {
  if (X < 1 || Y < 1 || Z < 1) return (int)cudaGetLastError();
  const bool vec = Z % kRun == 0 && aligned16(vals) && aligned16(wts) &&
                   aligned16(vals_out) && aligned16(wts_out);
  const Kernel kernel = pick(vec);
  const size_t smem = smem_bytes(n_views);
  if (smem > 48 * 1024) {  // past the default: opt in (more than 1000 views)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_z = (Z + kTileZ - 1) / kTileZ;
  const int tiles_y = (Y + kTileY - 1) / kTileY;
  const dim3 grid((tiles_z + kWarpsZ - 1) / kWarpsZ,
                  (tiles_y + kWarpsY - 1) / kWarpsY,
                  (X + kTileX - 1) / kTileX);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      vals, wts, depths, projs, kinv_row2, n_views, h, w, X, Y, Z, tdist,
      wmax, vals_out, wts_out, cull_out);
  return (int)cudaGetLastError();
}

// out[6]: registers, local (spill) bytes per thread, threads per CTA, CTAs
// per SM at n_views views, the dynamic shared bytes that takes, and 0 (no
// persistent grid), for the 16-byte (vec) or the scalar instantiation
extern "C" int dfb_fuse_depth_multi_info(int vec, int n_views, int* out) {
  const Kernel kernel = pick(vec != 0);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem_bytes(n_views));
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = kThreads;
  out[3] = per_sm;
  out[4] = (int)smem_bytes(n_views);
  out[5] = 0;
  return (int)cudaGetLastError();
}
