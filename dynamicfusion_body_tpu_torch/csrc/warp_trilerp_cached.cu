// K2: cached warp + live-TSDF trilerp, one CTA per canonical brick.
//
// Replaces the TPU kernel
// dynamicfusion_body_tpu/ops/trilerp_pallas.py:warp_trilerp_bricks_cached
// (pallas_call body _warp_kernel_cached, with _mip_class and _interp_one).
//
// Per brick b (brick^3 voxels, one thread each):
//  1. the brick's C candidate node DQs go to shared memory;
//  2. each voxel decodes its k cached slots (sel >> 5j) & 31, blends the
//     8 DQ components with the cached Gaussian weights selw, normalizes by
//     the 8-norm (identity fallback where the squared norm is below
//     FLT_MIN, see ops/dualquat.py:NORM2_MIN), warps its centre, then
//     applies the global pose lw — the same operations in the same order as
//     ops/compwise.py, so with -fmad=false the result rounds as the
//     PyTorch twin's does;
//  3. a block reduction over the in-volume samples gives the brick's
//     floor-coordinate range, which the live-space mip certificate reads
//     (3x3x3 live-brick window): a covered brick whose taps are all
//     <= -tdist emits -tdist, a covered brick whose taps are one value
//     emits it, and a brick with no in-volume sample emits -tdist;
//  4. every other sample is trilerped straight from global memory with the
//     formula of models/warp_field.py:_trilinear_c (clip, floor,
//     x1 = min(x0+1, r-1), lerp x then y then z; trilerp.cuh).
// valid = in-volume. There is no staging box, so no sample escapes.
// The brick grid and the voxel centres come from the canonical lattice
// (vy, vz: its extents, which may be padded up to a multiple of the brick);
// the in-volume test and the tap clamps from the live volume (rx, ry, rz),
// as the JAX kernel takes vol_shape apart from live.shape. The mip
// certificate needs the two equal (the wrapper checks).
//
// Bound on this card: memory. At 256^3 (NB = 32768, V = 512, k = 3) a
// frame reads sel 64 MB + selw 192 MB + live >= 64 MB (8 taps, mostly
// L2 hits) and writes vals/wx/wy/wz 4 x 64 MB + valid 16 MB: ~0.6 GB.
// Design: one CTA per brick keeps the per-voxel streams (sel, selw, the
// outputs) coalesced — thread v touches word v of the brick's row — and
// the candidate rows are read once per brick. The trilerp taps of one
// brick fall in a small region of live, so they stay in L1/L2 without a
// shared-memory box; a short-circuited brick reads no taps at all.

#include "trilerp.cuh"

namespace {

constexpr int kMaxSlots = 32;  // 5-bit packed slots
constexpr float kBig = 1e9f;

__device__ int floor_div8(int x) { return x >= 0 ? x / 8 : -((7 - x) / 8); }

__device__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__global__ void warp_trilerp_cached_kernel(
    const float* __restrict__ live, const float* __restrict__ node_dq,
    const int* __restrict__ cand, const int* __restrict__ sel,
    const float* __restrict__ selw, const float* __restrict__ lw,
    const float* __restrict__ mip_mn, const float* __restrict__ mip_mx,
    int use_mip, float tdist, int rx, int ry, int rz, int vy, int vz,
    int brick, int C, int k, float* __restrict__ vals,
    unsigned char* __restrict__ valid, float* __restrict__ wx_out,
    float* __restrict__ wy_out, float* __restrict__ wz_out) {
  __shared__ float s_dq[kMaxSlots * 8];
  __shared__ float s_red[6][32];
  __shared__ int s_short;
  __shared__ float s_cval;

  const int b = blockIdx.x;
  const int v = threadIdx.x;
  const int V = blockDim.x;
  const int64_t row = (int64_t)b * V + v;

  for (int i = v; i < C * 8; i += V) {
    s_dq[i] = node_dq[(int64_t)cand[(int64_t)b * C + i / 8] * 8 + i % 8];
  }
  __syncthreads();

  // ---- blend the cached selection, normalize, warp --------------------
  const int nby = vy / brick, nbz = vz / brick;
  float px = (float)((b / (nby * nbz)) * brick + v / (brick * brick));
  float py = (float)(((b / nbz) % nby) * brick + (v / brick) % brick);
  float pz = (float)((b % nbz) * brick + v % brick);
  const int s = sel[row];
  float acc[8];
  for (int j = 0; j < k; ++j) {
    const float* d = s_dq + ((s >> (5 * j)) & 31) * 8;
    const float w = selw[((int64_t)b * k + j) * V + v];
    for (int e = 0; e < 8; ++e) acc[e] = j ? acc[e] + w * d[e] : w * d[e];
  }
  float se3[8];
  dq_normalize8(acc, se3);
  dq_point(se3, px, py, pz);
  float lwr[8];
  for (int e = 0; e < 8; ++e) lwr[e] = lw[e];
  dq_point(lwr, px, py, pz);
  wx_out[row] = px;
  wy_out[row] = py;
  wz_out[row] = pz;
  const bool invol = in_volume(px, py, pz, rx, ry, rz);
  valid[row] = invol ? 1 : 0;

  // ---- live-space mip certificate ---------------------------------------
  if (use_mip) {
    float r[6] = {invol ? px : kBig,  invol ? py : kBig,  invol ? pz : kBig,
                  invol ? px : -kBig, invol ? py : -kBig, invol ? pz : -kBig};
    const int lane = v & 31, wid = v >> 5;
    for (int q = 0; q < 3; ++q) r[q] = warp_min(r[q]);
    for (int q = 3; q < 6; ++q) r[q] = warp_max(r[q]);
    if (lane == 0) {
      for (int q = 0; q < 6; ++q) s_red[q][wid] = r[q];
    }
    __syncthreads();
    if (v == 0) {
      const int nw = (V + 31) / 32;
      for (int w = 1; w < nw; ++w) {
        for (int q = 0; q < 3; ++q) r[q] = fminf(r[q], s_red[q][w]);
        for (int q = 3; q < 6; ++q) r[q] = fmaxf(r[q], s_red[q][w]);
      }
      const int nl[3] = {rx / 8, ry / 8, rz / 8};
      int lo[3], hi[3];
      for (int a = 0; a < 3; ++a) {
        lo[a] = min(max(floor_div8((int)floorf(r[a])), 0), nl[a] - 1);
        hi[a] = min(max(floor_div8((int)floorf(r[3 + a])), 0), nl[a] - 1);
      }
      const bool has_v = r[0] <= r[3];
      const bool covered =
          hi[0] - lo[0] <= 2 && hi[1] - lo[1] <= 2 && hi[2] - lo[2] <= 2;
      float amin = kBig, amax = -kBig;
      if (covered) {
        for (int xi = lo[0]; xi <= hi[0]; ++xi)
          for (int yi = lo[1]; yi <= hi[1]; ++yi)
            for (int zi = lo[2]; zi <= hi[2]; ++zi) {
              const int64_t m = ((int64_t)xi * nl[1] + yi) * nl[2] + zi;
              amin = fminf(amin, mip_mn[m]);
              amax = fmaxf(amax, mip_mx[m]);
            }
      }
      const bool is_skip = covered && amax <= -tdist;
      const bool is_const = covered && amin == amax;
      s_short = (!has_v || is_skip || is_const) ? 1 : 0;
      s_cval = is_skip ? -tdist : amin;
    }
    __syncthreads();
    if (s_short) {
      vals[row] = s_cval;
      return;
    }
  }

  // ---- exact trilerp of live (models/warp_field.py:_trilinear_c) -------
  vals[row] = trilerp_c(live, rx, ry, rz, px, py, pz);
}

}  // namespace

extern "C" int dfb_warp_trilerp_cached(
    const float* live, const float* node_dq, const int* cand, const int* sel,
    const float* selw, const float* lw, const float* mip_mn,
    const float* mip_mx, int use_mip, float tdist, int rx, int ry, int rz,
    int vy, int vz, int brick, int NB, int C, int k, float* vals,
    unsigned char* valid, float* wx, float* wy, float* wz, void* stream) {
  const int V = brick * brick * brick;
  if (NB > 0) {
    warp_trilerp_cached_kernel<<<NB, V, 0, (cudaStream_t)stream>>>(
        live, node_dq, cand, sel, selw, lw, mip_mn, mip_mx, use_mip, tdist,
        rx, ry, rz, vy, vz, brick, C, k, vals, valid, wx, wy, wz);
  }
  return (int)cudaGetLastError();
}
