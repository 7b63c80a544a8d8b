// K3: per-voxel node selection + DQB warp + live-TSDF trilerp over
// canonical bricks, on a persistent grid of 256-thread CTAs.
//
// Replaces the TPU kernel
// dynamicfusion_body_tpu/ops/trilerp_pallas.py:warp_trilerp_bricks
// (pallas_call body _warp_kernel, with _interp_one): the sample stage of the
// non-rigid TSDF update when no warp cache is given.
//
// What it computes, per canonical voxel (the PyTorch twin,
// ops/trilerp_cuda.py:warp_trilerp_bricks_ref, in the same order of
// operations):
//  1. d2 to each of the brick's C candidate nodes as dx*dx + dy*dy + dz*dz
//     (an inactive or padding slot gets 3.4e38), then k argmin passes with a
//     strict < scan in ascending slot order — the first-min tie-break of the
//     JAX kernel and of models/warp_field.py:build_warp_cache. Per pick:
//     dk = sqrt(min(best, BIG)), finite = active && best < 1e18,
//     w = finite ? exp(-(dk / (2 node_w))^2) : 0;
//     wi = sum(finite * dk) / max(count, 1);
//  2. the DQ blend sums the picks in selection order (j = 0 .. k-1), as K2
//     does over its cached selection, then normalizes (identity below
//     FLT_MIN), warps the voxel centre and applies the global pose lw;
//  3. valid = inside the live volume; every sample is trilerped straight
//     from global memory (trilerp.cuh); the warped coordinates are written
//     only when asked for.
// So K3 equals build_warp_cache followed by K2 without the mip certificate,
// wherever expf agrees with ATen's exp. The JAX kernel sums the blend over
// all C in candidate order; the port's order differs within f32 rounding.
// There is no staging box, so no sample escapes (the JAX kernel's escaped
// output has no counterpart), and there is no mip certificate (the JAX
// kernel has none either). The brick grid and the voxel centres come from
// the canonical lattice (vy, vz); the in-volume test and the tap clamps from
// live (rx, ry, rz).
//
// Bound on this card: operations. At 256^3 (NB = 32768, V = 512, C = 16,
// k = 3) a voxel needs ~460 f32 operations (d2 8 per active slot, k (C-1)
// compares, per pick 28 with its blend, normalize 26, two pruned sandwiches
// 138, bounds 6, trilerp 40): ~7.7 G operations, ~0.115 ms at 67 TFLOP/s.
// With -fmad=false (kept so that the kernel rounds as its twin) every
// multiply and add is its own instruction, so the issue ceiling is half
// that rate: ~0.23 ms. The instructions issued are far more than the
// operations counted (the IEEE sqrt, division and exp sequences, the
// argmin's compare-selects and slot clears, addressing): issue is what
// holds the kernel. Bytes: ~0.22 GB of outputs, taps and node rows without
// coordinates, ~0.42 GB with them.
//
// Design. The earlier version gave each brick one 512-thread CTA that
// loaded its candidate and node rows, waited at a barrier, and only then
// computed; nothing overlapped one brick's loads with another's work, and
// the sandwich multiplied by v's literal zeros. Here:
//  - gridDim.x CTAs (as many as fit on the card) walk the bricks
//    b = blockIdx.x + i * gridDim.x; each thread owns a voxel pair
//    (2p, 2p+1), z-neighbours, one after the other, and stores vals and
//    wi as float2 and valid as a 2-byte pair;
//  - a 2-stage shared-memory ring filled with cp.async: the node rows
//    (position and support as one float4, the active flag, the DQ) of brick
//    i+1's candidates are in flight while brick i computes, and brick i+2's
//    candidate row (the gather needs it a brick ahead);
//  - the d2 row of a voxel lives in registers (the slot count KC is a
//    template parameter, so every loop over slots unrolls and indexes
//    registers statically), each with its own register budget
//    (__launch_bounds__ below);
//  - the sandwich with v's literal zeros and ones pruned (trilerp.cuh), the
//    global pose read from shared memory, loaded once per CTA; the taps
//    addressed by 32-bit offsets from one base (trilerp.cuh:trilerp_c32);
//    the pick after the last pass leaves no slot to clear;
//  - no coordinate stores unless the caller asks (the TSDF update reads
//    vals, valid and wi).

#include "trilerp.cuh"

namespace {

constexpr int kMaxCand = 32;
constexpr int kMaxK = 6;  // the twin's limit (5-bit packed slots)
constexpr float kBigD2 = 3.4e38f;  // models/warp_field.py:_BIG
// CTAs per SM each instantiation's register budget is built for: the most
// that compile without a spill (measured on sm_90a: 80 registers at KC = 8,
// 85 at 16 and 101 at 32; three CTAs would spill at 16 and 32)
constexpr int kMinBlocks8 = 3, kMinBlocksWide = 2;

// One stage of the ring: the candidates' (x, y, z, node_w), active flags
// and DQs.
template <int KC>
struct Stage {
  float4 node[KC];
  float dq[KC * 8];
  int act[KC];
};

// The node rows of brick b's candidates (s_cand: its candidate row, already
// in shared memory): 7 copies a candidate, thread i taking part i % 8 of
// candidate i / 8 (8 C <= 256 threads, so one copy at most a thread). A
// node id outside [0, M) is clamped into it, so no copy leaves the pool.
template <int KC>
__device__ __forceinline__ void fetch_nodes(
    Stage<KC>& st, const int* s_cand, const float* node_pos,
    const float* node_w, const int* active, const float* node_dq, int M,
    int b, int NB, int C) {
  const int i = threadIdx.x, c = i >> 3, part = i & 7;
  if (b < NB && c < C && part < 7) {
    const int64_t n = min(max(s_cand[c], 0), M - 1);
    float* node = &st.node[c].x;
    if (part < 3) {
      cp_async4(node + part, node_pos + 3 * n + part);
    } else if (part == 3) {
      cp_async4(node + 3, node_w + n);
    } else if (part == 4) {
      cp_async4(st.act + c, active + n);
    } else {
      const int h = part - 5;
      cp_async16(st.dq + c * 8 + 4 * h, node_dq + 8 * n + 4 * h);
    }
  }
  cp_async_commit();
}

// Steps 1-2 for the voxel centre p (overwritten by its warped position);
// returns wi.
template <int KC>
__device__ __forceinline__ float select_warp(const Stage<KC>& st,
                                             unsigned amask,
                                             const float* s_lw, int k,
                                             float& px, float& py,
                                             float& pz) {
  // ---- distances to the brick's candidates ----------------------------
  float d2[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    d2[c] = kBigD2;
    if ((amask >> c) & 1u) {
      const float4 nd = st.node[c];
      const float dx = px - nd.x;
      const float dy = py - nd.y;
      const float dz = pz - nd.z;
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
    const bool finite = ((amask >> bc) & 1u) && best < 1e18f;
    float w = 0.f;
    if (finite) {
      const float t = dk / (2.f * st.node[bc].w);
      w = expf(-(t * t));
    }
    const float4* d = (const float4*)(st.dq + bc * 8);
    const float4 d0 = d[0], d1 = d[1];
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = j ? acc[e] + w * dv[e] : w * dv[e];
    wi_sum = wi_sum + (finite ? dk : 0.f);
    wi_cnt = wi_cnt + (finite ? 1.f : 0.f);
    if (j + 1 < k) {  // the pick leaves the next passes' scan
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (c == bc) d2[c] = kBigD2;
      }
    }
  }

  // ---- normalize, warp, global pose -----------------------------------
  float se3[8];
  dq_normalize8(acc, se3);
  dq_point(se3, px, py, pz);
  dq_point(s_lw, px, py, pz);
  return wi_sum / fmaxf(wi_cnt, 1.f);
}

template <int KC>
__global__ void __launch_bounds__(kPairThreads,
                                  KC <= 8 ? kMinBlocks8 : kMinBlocksWide)
    warp_trilerp_bricks_kernel(
        const float* __restrict__ live, const float* __restrict__ node_pos,
        const float* __restrict__ node_w, const int* __restrict__ active,
        const float* __restrict__ node_dq, const int* __restrict__ cand,
        const float* __restrict__ lw, int rx, int ry, int rz, int vy, int vz,
        int brick, int NB, int C, int k, int M, float* __restrict__ vals,
        unsigned char* __restrict__ valid, float* __restrict__ wi_out,
        float* __restrict__ wx_out, float* __restrict__ wy_out,
        float* __restrict__ wz_out) {
  __shared__ __align__(16) Stage<KC> s_ring[2];
  __shared__ int s_cand[2][kMaxCand];
  __shared__ float s_lw[8];

  const int tid = threadIdx.x;
  const int V = brick * brick * brick;
  const int nby = vy / brick, nbz = vz / brick;
  const bool has_pair = 2 * tid < V;
  // this thread's voxel pair inside a brick: (ox, oy, oz) and (ox, oy, oz+1)
  const int v = 2 * tid;
  const int ox = v / (brick * brick), oy = (v / brick) % brick,
            oz = v % brick;
  const int G = gridDim.x;
  const bool coords = wx_out != nullptr;

  if (tid < 8) s_lw[tid] = lw[tid];
  int b = blockIdx.x;
  fetch_cand(s_cand[0], cand, b, NB, C);
  fetch_cand(s_cand[1], cand, b + G, NB, C);
  cp_async_wait_all();
  __syncthreads();
  fetch_nodes(s_ring[0], s_cand[0], node_pos, node_w, active, node_dq, M, b,
              NB, C);

  for (int it = 0; b < NB; ++it, b += G) {
    const int s = it & 1;
    cp_async_wait_all();
    __syncthreads();  // brick b's node rows and brick b+G's candidates landed
    fetch_nodes(s_ring[s ^ 1], s_cand[s ^ 1], node_pos, node_w, active,
                node_dq, M, b + G, NB, C);
    fetch_cand(s_cand[s], cand, b + 2 * G, NB, C);
    if (!has_pair) continue;
    const Stage<KC>& st = s_ring[s];
    unsigned amask = 0;  // active candidate slots
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c < C && st.act[c]) amask |= 1u << c;
    }

    const int64_t row = (int64_t)b * V + v;
    const int x0 = (b / (nby * nbz)) * brick + ox;
    const int y0 = ((b / nbz) % nby) * brick + oy;
    const int z0 = (b % nbz) * brick + oz;
    // the pair's voxels one after the other, each to its trilerp (not
    // interleaved, which would double the registers a voxel holds); vals,
    // wi and valid go out as pairs, the coordinates (not on the update's
    // path) voxel by voxel
    float wi0 = 0.f, val0 = 0.f, wi1 = 0.f, val1 = 0.f;
    bool inv0 = false, inv1 = false;
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      float x = (float)x0, y = (float)y0, z = (float)(z0 + u);
      const float w = select_warp<KC>(st, amask, s_lw, k, x, y, z);
      const bool in = in_volume(x, y, z, rx, ry, rz);
      const float val = trilerp_c32(live, rx, ry, rz, x, y, z);
      if (coords) {
        wx_out[row + u] = x;
        wy_out[row + u] = y;
        wz_out[row + u] = z;
      }
      if (u == 0) {
        wi0 = w, val0 = val, inv0 = in;
      } else {
        wi1 = w, val1 = val, inv1 = in;
      }
    }
    *(float2*)(wi_out + row) = make_float2(wi0, wi1);
    *(uchar2*)(valid + row) = make_uchar2(inv0, inv1);
    *(float2*)(vals + row) = make_float2(val0, val1);
  }
}

template <int KC>
int launch(cudaStream_t stream, const float* live, const float* node_pos,
           const float* node_w, const int* active, const float* node_dq,
           const int* cand, const float* lw, int rx, int ry, int rz, int vy,
           int vz, int brick, int NB, int C, int k, int M, float* vals,
           unsigned char* valid, float* wi, float* wx, float* wy,
           float* wz) {
  const int grid = persistent_grid(warp_trilerp_bricks_kernel<KC>, 0, NB);
  warp_trilerp_bricks_kernel<KC><<<grid, kPairThreads, 0, stream>>>(
      live, node_pos, node_w, active, node_dq, cand, lw, rx, ry, rz, vy, vz,
      brick, NB, C, k, M, vals, valid, wi, wx, wy, wz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dfb_warp_trilerp_bricks(
    const float* live, const float* node_pos, const float* node_w,
    const int* active, const float* node_dq, const int* cand, const float* lw,
    int rx, int ry, int rz, int vy, int vz, int brick, int NB, int C, int k,
    int M, float* vals, unsigned char* valid, float* wi, float* wx, float* wy,
    float* wz, void* stream) {
  if (C < 1 || C > kMaxCand || k < 1 || k > C || k > kMaxK || brick < 2 ||
      brick > 8 || brick % 2 || M < 1)
    return (int)cudaErrorInvalidValue;
  if (NB <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (C <= 8)
    return launch<8>(s, live, node_pos, node_w, active, node_dq, cand, lw, rx,
                     ry, rz, vy, vz, brick, NB, C, k, M, vals, valid, wi, wx,
                     wy, wz);
  if (C <= 16)
    return launch<16>(s, live, node_pos, node_w, active, node_dq, cand, lw,
                      rx, ry, rz, vy, vz, brick, NB, C, k, M, vals, valid, wi,
                      wx, wy, wz);
  return launch<32>(s, live, node_pos, node_w, active, node_dq, cand, lw, rx,
                    ry, rz, vy, vz, brick, NB, C, k, M, vals, valid, wi, wx,
                    wy, wz);
}

// out[6] for the instantiation that C candidates take: see
// trilerp.cuh:kernel_info
extern "C" int dfb_warp_trilerp_bricks_info(int C, int* out) {
  if (C < 1 || C > kMaxCand) return (int)cudaErrorInvalidValue;
  if (C <= 8) return kernel_info(warp_trilerp_bricks_kernel<8>, 0, out);
  if (C <= 16) return kernel_info(warp_trilerp_bricks_kernel<16>, 0, out);
  return kernel_info(warp_trilerp_bricks_kernel<32>, 0, out);
}
