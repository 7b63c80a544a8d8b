// K3: per-voxel node selection + DQB warp + live-TSDF trilerp, one CTA per
// canonical brick.
//
// Replaces the TPU kernel
// dynamicfusion_body_tpu/ops/trilerp_pallas.py:warp_trilerp_bricks
// (pallas_call body _warp_kernel, with _interp_one): the sample stage of the
// non-rigid TSDF update when no warp cache is given.
//
// Per brick b (brick^3 voxels, one thread each):
//  1. the brick's C candidate nodes (position, support node_w, active flag,
//     DQ) go to shared memory, read straight from the WarpField arrays;
//  2. each voxel computes d2 to every candidate as dx*dx + dy*dy + dz*dz
//     (an inactive or padding slot gets 3.4e38) and takes k argmin passes
//     with a strict < scan in ascending slot order — the first-min
//     tie-break of the JAX kernel and of models/warp_field.py:
//     build_warp_cache. Per pick: dk = sqrt(min(best, BIG)), finite =
//     active && best < 1e18, w = finite ? exp(-(dk / (2 node_w))^2) : 0;
//     wi = sum(finite * dk) / max(count, 1);
//  3. the DQ blend sums the picks in selection order (j = 0 .. k-1), as K2
//     does over its cached selection, then normalizes (identity below
//     FLT_MIN), warps the voxel centre and applies the global pose lw;
//  4. every sample is trilerped straight from global memory (trilerp.cuh).
// So K3 equals build_warp_cache followed by K2 without the mip certificate,
// wherever expf agrees with ATen's exp. The JAX kernel sums the blend over
// all C in candidate order; the port's order differs within f32 rounding.
// valid = in-volume: there is no staging box, so no sample escapes (the JAX
// kernel's escaped output has no counterpart), and there is no mip
// certificate (the JAX kernel has none either).
//
// The brick grid and the voxel centres come from the canonical lattice
// (vy, vz: its extents, padded up to a multiple of the brick by the
// caller); the in-volume test and the tap clamps from live (rx, ry, rz).
//
// Bound on this card: operations. At 256^3 (NB = 32768, V = 512, C = 16,
// k = 3) a voxel does ~750 f32 operations (d2 128, the argmin passes ~150,
// the picks ~60, blend 48, normalize 25, two sandwiches 352, trilerp 40):
// ~12.6 G operations, ~0.19 ms at 67 TFLOP/s, against ~0.42 GB of outputs,
// taps and candidates, ~0.13 ms at 3.35 TB/s. Design: the d2 row of a voxel
// lives in registers (the slot count KC is a template parameter, so every
// loop over slots unrolls and indexes registers statically), the candidate
// rows are read once per brick into shared memory, and the per-voxel
// outputs are coalesced (thread v writes word v of the brick's row).

#include "trilerp.cuh"

namespace {

constexpr int kMaxCand = 32;
constexpr float kBigD2 = 3.4e38f;  // models/warp_field.py:_BIG

template <int KC>
__global__ void warp_trilerp_bricks_kernel(
    const float* __restrict__ live, const float* __restrict__ node_pos,
    const float* __restrict__ node_w,
    const unsigned char* __restrict__ active,
    const float* __restrict__ node_dq, const int* __restrict__ cand,
    const float* __restrict__ lw, int rx, int ry, int rz, int vy, int vz,
    int brick, int C, int k, float* __restrict__ vals,
    unsigned char* __restrict__ valid, float* __restrict__ wi_out,
    float* __restrict__ wx_out, float* __restrict__ wy_out,
    float* __restrict__ wz_out) {
  __shared__ float s_pos[KC * 3];
  __shared__ float s_w[KC];
  __shared__ int s_act[KC];
  __shared__ float s_dq[KC * 8];

  const int b = blockIdx.x;
  const int v = threadIdx.x;
  const int V = blockDim.x;
  const int64_t row = (int64_t)b * V + v;

  for (int i = v; i < C; i += V) {
    const int64_t n = cand[(int64_t)b * C + i];
    s_pos[3 * i] = node_pos[3 * n];
    s_pos[3 * i + 1] = node_pos[3 * n + 1];
    s_pos[3 * i + 2] = node_pos[3 * n + 2];
    s_w[i] = node_w[n];
    s_act[i] = active[n];
  }
  for (int i = v; i < C * 8; i += V) {
    s_dq[i] = node_dq[(int64_t)cand[(int64_t)b * C + i / 8] * 8 + i % 8];
  }
  __syncthreads();

  // ---- per-voxel distances to the brick's candidates ------------------
  const int nby = vy / brick, nbz = vz / brick;
  float px = (float)((b / (nby * nbz)) * brick + v / (brick * brick));
  float py = (float)(((b / nbz) % nby) * brick + (v / brick) % brick);
  float pz = (float)((b % nbz) * brick + v % brick);
  float d2[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    d2[c] = kBigD2;
    if (c < C && s_act[c]) {
      const float dx = px - s_pos[3 * c];
      const float dy = py - s_pos[3 * c + 1];
      const float dz = pz - s_pos[3 * c + 2];
      d2[c] = dx * dx + dy * dy + dz * dz;
    }
  }

  // ---- k argmin passes (first-min tie-break), weights, blend ----------
  float acc[8];
  float wi_sum = 0.f, wi_cnt = 0.f;
  for (int j = 0; j < k; ++j) {
    float best = d2[0];
    int bc = 0;
#pragma unroll
    for (int c = 1; c < KC; ++c) {
      if (d2[c] < best) {
        best = d2[c];
        bc = c;
      }
    }
    const float dk = sqrtf(fminf(best, kBigD2));
    const bool finite = s_act[bc] && best < 1e18f;
    float w = 0.f;
    if (finite) {
      const float t = dk / (2.f * s_w[bc]);
      w = expf(-(t * t));
    }
    const float* d = s_dq + bc * 8;
    for (int e = 0; e < 8; ++e) acc[e] = j ? acc[e] + w * d[e] : w * d[e];
    wi_sum = wi_sum + (finite ? dk : 0.f);
    wi_cnt = wi_cnt + (finite ? 1.f : 0.f);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c == bc) d2[c] = kBigD2;
    }
  }
  wi_out[row] = wi_sum / fmaxf(wi_cnt, 1.f);

  // ---- normalize, warp, global pose, trilerp --------------------------
  float se3[8];
  dq_normalize8(acc, se3);
  dq_point(se3, px, py, pz);
  float lwr[8];
  for (int e = 0; e < 8; ++e) lwr[e] = lw[e];
  dq_point(lwr, px, py, pz);
  wx_out[row] = px;
  wy_out[row] = py;
  wz_out[row] = pz;
  valid[row] = in_volume(px, py, pz, rx, ry, rz) ? 1 : 0;
  vals[row] = trilerp_c(live, rx, ry, rz, px, py, pz);
}

template <int KC>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const float* live,
            const float* node_pos, const float* node_w,
            const unsigned char* active, const float* node_dq,
            const int* cand, const float* lw, int rx, int ry, int rz, int vy,
            int vz, int brick, int C, int k, float* vals,
            unsigned char* valid, float* wi, float* wx, float* wy,
            float* wz) {
  warp_trilerp_bricks_kernel<KC><<<grid, block, 0, stream>>>(
      live, node_pos, node_w, active, node_dq, cand, lw, rx, ry, rz, vy, vz,
      brick, C, k, vals, valid, wi, wx, wy, wz);
}

}  // namespace

extern "C" int dfb_warp_trilerp_bricks(
    const float* live, const float* node_pos, const float* node_w,
    const unsigned char* active, const float* node_dq, const int* cand,
    const float* lw, int rx, int ry, int rz, int vy, int vz, int brick,
    int NB, int C, int k, float* vals, unsigned char* valid, float* wi,
    float* wx, float* wy, float* wz, void* stream) {
  if (C < 1 || C > kMaxCand || k < 1 || k > C) return (int)cudaErrorInvalidValue;
  const int V = brick * brick * brick;
  if (NB > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (C <= 8) {
      launch<8>(NB, V, s, live, node_pos, node_w, active, node_dq, cand, lw,
                rx, ry, rz, vy, vz, brick, C, k, vals, valid, wi, wx, wy, wz);
    } else if (C <= 16) {
      launch<16>(NB, V, s, live, node_pos, node_w, active, node_dq, cand, lw,
                 rx, ry, rz, vy, vz, brick, C, k, vals, valid, wi, wx, wy,
                 wz);
    } else {
      launch<32>(NB, V, s, live, node_pos, node_w, active, node_dq, cand, lw,
                 rx, ry, rz, vy, vz, brick, C, k, vals, valid, wi, wx, wy,
                 wz);
    }
  }
  return (int)cudaGetLastError();
}
