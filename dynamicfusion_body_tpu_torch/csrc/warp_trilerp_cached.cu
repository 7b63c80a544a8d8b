// K2: cached warp + live-TSDF trilerp over canonical bricks, on a
// persistent grid of 256-thread CTAs.
//
// Replaces the TPU kernel
// dynamicfusion_body_tpu/ops/trilerp_pallas.py:warp_trilerp_bricks_cached
// (pallas_call body _warp_kernel_cached, with _mip_class and _interp_one).
//
// What it computes, per canonical voxel (the PyTorch twin,
// ops/trilerp_cuda.py:warp_trilerp_bricks_cached_ref, in the same order of
// operations, so with -fmad=false the two round alike):
//  1. decode the k cached slots (sel >> 5j) & 31 into the brick's candidate
//     node DQs, blend the 8 components with the cached Gaussian weights
//     selw in slot order, normalize by the 8-norm (identity where the
//     squared norm is below FLT_MIN, see ops/dualquat.py:NORM2_MIN), warp
//     the voxel centre, apply the global pose lw (trilerp.cuh:dq_point);
//  2. valid = inside the live volume (there is no staging box, so no sample
//     escapes); the warped coordinates are written only when asked for;
//  3. with the live-space mip certificate (use_mip), a brick whose
//     in-volume samples' floor cells fit a 3x3x3 live-brick window whose
//     taps are all <= -tdist emits -tdist, one whose taps are one value
//     emits it, and a brick with no in-volume sample emits -tdist;
//  4. every other sample is trilerped straight from global memory with
//     models/warp_field.py:_trilinear_c's formula (trilerp.cuh).
// The brick grid and the voxel centres come from the canonical lattice
// (vy, vz: its extents, which may be padded up to a multiple of the brick);
// the in-volume test and the tap clamps from the live volume (rx, ry, rz),
// as the JAX kernel takes vol_shape apart from live.shape. The mip
// certificate needs the two equal (the wrapper checks).
//
// Bound on this card: memory. At 256^3 (NB = 32768, V = 512, k = 3) a call
// reads sel 64 MB + selw 192 MB + the live cells the full bricks tap, and
// writes vals 64 MB + valid 16 MB (+ wx, wy, wz 3 x 64 MB when asked):
// ~0.39 GB, ~0.115 ms at 3.35 TB/s (~0.59 GB with coordinates). Its
// arithmetic, ~216 operations a voxel with the pruned sandwich, is about
// as long: the two are near balance, so the kernel has to keep both the
// memory system and the ALUs busy.
//
// Design. The earlier version gave each brick one 512-thread CTA that ran
// a serial chain of memory round trips and barriers (candidate row, node
// rows, per-voxel streams, a min/max whose 27 mip cells thread 0 loaded
// alone, then the taps) with nothing to overlap it. Here:
//  - the block is decoupled from the brick: gridDim.x CTAs (as many as fit
//    on the card: 3 of 256 threads a SM, the most whose registers do not
//    spill) walk the bricks b = blockIdx.x + i * gridDim.x; each thread
//    owns a voxel pair (2p, 2p+1), z-neighbours, warped one after the other
//    (interleaved, they would double the registers), and stores vals as
//    float2 and valid as a 2-byte pair, so every warp store is one
//    contiguous run;
//  - a 2-stage shared-memory ring, filled with cp.async: while brick i
//    computes, brick i+1's sel and selw rows and the node DQ rows its
//    candidates name are in flight, and the candidate row of brick i+2 (the
//    gather needs it one brick ahead of itself);
//  - the mip certificate: warp shuffles and one shared-memory exchange
//    reduce the brick's coordinate range, then one warp loads the up to 27
//    mip cells at once (one per lane) and reduces them; the short-circuit is
//    decided before any tap is loaded;
//  - the sandwich with v's literal zeros and ones pruned (trilerp.cuh), the
//    global pose read from shared memory, loaded once per CTA; the taps
//    addressed by 32-bit offsets from one base (trilerp.cuh:trilerp_c32);
//  - no coordinate stores unless the caller asks (the TSDF update reads
//    vals, valid and nothing else).

#include "trilerp.cuh"

namespace {

constexpr int kMaxSlots = 32;  // 5-bit packed slots
constexpr int kMaxK = 6;       // slots a 32-bit sel holds
constexpr int kWarps = kPairThreads / 32;
constexpr float kBig = 1e9f;
// CTAs per SM the register budget is built for: the most that compile
// without a spill (78 registers on sm_90a; four would spill)
constexpr int kMinBlocks = 3;

__device__ __forceinline__ int floor_div8(int x) {
  return x >= 0 ? x / 8 : -((7 - x) / 8);
}

// One stage of the ring, in 4-byte words: sel row (V), selw rows (k V),
// the candidates' node DQs (kMaxSlots x 8). 16-byte aligned for an even
// brick (V a multiple of 8).
__host__ __device__ __forceinline__ int stage_words(int V, int k) {
  return V * (1 + k) + kMaxSlots * 8;
}

// sel and selw rows of brick b, and the node DQ rows of its candidates
// (s_cand: brick b's candidate row, already in shared memory; a node id
// outside [0, M) is clamped into it, so no copy leaves the node pool)
__device__ __forceinline__ void fetch_rows(float* stage, const int* s_cand,
                                           const int* sel, const float* selw,
                                           const float* node_dq, int M,
                                           int b, int NB, int V, int C,
                                           int k) {
  const int i = threadIdx.x;
  if (b < NB) {
    // (1 + k) V / 4 chunks of 16 bytes: the sel row, then the k selw rows
    const int n_sel = V / 4, n_rows = n_sel * (1 + k);
    const float* row_sel = (const float*)(sel + (int64_t)b * V);
    const float* row_selw = selw + (int64_t)b * k * V;
#pragma unroll 1
    for (int r = i; r < n_rows; r += kPairThreads)
      cp_async16(stage + 4 * r, r < n_sel ? row_sel + 4 * r
                                          : row_selw + 4 * (r - n_sel));
    if (i < 2 * C) {  // 2 C <= 64 chunks of node DQ rows
      const int n = min(max(s_cand[i >> 1], 0), M - 1);
      cp_async16(stage + V * (1 + k) + 4 * i,
                 node_dq + (int64_t)n * 8 + 4 * (i & 1));
    }
  }
  cp_async_commit();
}

// Steps 1-2 for voxel v of a brick, whose centre is (x, y, z): the warped
// coordinates and the in-volume flag.
__device__ __forceinline__ bool warp_voxel(const float* stage,
                                           const float* s_lw, int V, int k,
                                           int v, int x, int y, int z,
                                           int rx, int ry, int rz, float& px,
                                           float& py, float& pz) {
  const int* s_sel = (const int*)stage;
  const float* s_selw = stage + V;
  const float* s_dq = stage + V * (1 + k);
  px = (float)x;
  py = (float)y;
  pz = (float)z;
  const int s = s_sel[v];
  float acc[8];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      const float4* d = (const float4*)(s_dq + ((s >> (5 * j)) & 31) * 8);
      const float4 d0 = d[0], d1 = d[1];
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float w = s_selw[j * V + v];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[e] = j ? acc[e] + w * dv[e] : w * dv[e];
    }
  }
  float se3[8];
  dq_normalize8(acc, se3);
  dq_point(se3, px, py, pz);
  dq_point(s_lw, px, py, pz);
  return in_volume(px, py, pz, rx, ry, rz);
}

__global__ void __launch_bounds__(kPairThreads, kMinBlocks)
    warp_trilerp_cached_kernel(
        const float* __restrict__ live, const float* __restrict__ node_dq,
        const int* __restrict__ cand, const int* __restrict__ sel,
        const float* __restrict__ selw, const float* __restrict__ lw,
        const float* __restrict__ mip_mn, const float* __restrict__ mip_mx,
        int use_mip, float tdist, int rx, int ry, int rz, int vy, int vz,
        int brick, int NB, int C, int k, int M, float* __restrict__ vals,
        unsigned char* __restrict__ valid, float* __restrict__ wx_out,
        float* __restrict__ wy_out, float* __restrict__ wz_out) {
  extern __shared__ __align__(16) float s_ring[];  // 2 stages
  __shared__ int s_cand[2][kMaxSlots];
  __shared__ float s_lw[8];
  __shared__ float s_red[6][kWarps];
  __shared__ int s_short;
  __shared__ float s_cval;

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int V = brick * brick * brick;
  const int words = stage_words(V, k);
  const int nby = vy / brick, nbz = vz / brick;
  const bool has_pair = 2 * tid < V;
  const int G = gridDim.x;
  const bool coords = wx_out != nullptr;
  // this thread's voxel pair inside a brick: (ox, oy, oz) and (ox, oy, oz+1)
  const int v = 2 * tid;
  const int ox = v / (brick * brick), oy = (v / brick) % brick,
            oz = v % brick;

  if (tid < 8) s_lw[tid] = lw[tid];
  int b = blockIdx.x;
  fetch_cand(s_cand[0], cand, b, NB, C);
  fetch_cand(s_cand[1], cand, b + G, NB, C);
  cp_async_wait_all();
  __syncthreads();
  fetch_rows(s_ring, s_cand[0], sel, selw, node_dq, M, b, NB, V, C, k);

  for (int it = 0; b < NB; ++it, b += G) {
    const int st = it & 1;
    cp_async_wait_all();
    __syncthreads();  // brick b's rows and brick b+G's candidates landed
    fetch_rows(s_ring + (st ^ 1) * words, s_cand[st ^ 1], sel, selw,
               node_dq, M, b + G, NB, V, C, k);
    fetch_cand(s_cand[st], cand, b + 2 * G, NB, C);
    const float* stage = s_ring + st * words;

    // ---- blend the cached selection, normalize, warp ------------------
    const int x0 = (b / (nby * nbz)) * brick + ox;
    const int y0 = ((b / nbz) % nby) * brick + oy;
    const int z0 = (b % nbz) * brick + oz;
    const int64_t row = (int64_t)b * V + v;
    // the pair's voxels one after the other (not interleaved, which would
    // double the registers a voxel's warp holds), the results in scalars
    float px0 = 0.f, py0 = 0.f, pz0 = 0.f, px1 = 0.f, py1 = 0.f, pz1 = 0.f;
    bool inv0 = false, inv1 = false;
    if (has_pair) {
#pragma unroll 1
      for (int u = 0; u < 2; ++u) {
        float x, y, z;
        const bool in = warp_voxel(stage, s_lw, V, k, v + u, x0, y0, z0 + u,
                                   rx, ry, rz, x, y, z);
        if (u == 0) {
          px0 = x, py0 = y, pz0 = z, inv0 = in;
        } else {
          px1 = x, py1 = y, pz1 = z, inv1 = in;
        }
      }
      *(uchar2*)(valid + row) = make_uchar2(inv0, inv1);
      if (coords) {
        *(float2*)(wx_out + row) = make_float2(px0, px1);
        *(float2*)(wy_out + row) = make_float2(py0, py1);
        *(float2*)(wz_out + row) = make_float2(pz0, pz1);
      }
    }

    // ---- live-space mip certificate -------------------------------------
    bool is_short = false;
    float cval = 0.f;
    if (use_mip) {
      float r[6] = {fminf(inv0 ? px0 : kBig, inv1 ? px1 : kBig),
                    fminf(inv0 ? py0 : kBig, inv1 ? py1 : kBig),
                    fminf(inv0 ? pz0 : kBig, inv1 ? pz1 : kBig),
                    fmaxf(inv0 ? px0 : -kBig, inv1 ? px1 : -kBig),
                    fmaxf(inv0 ? py0 : -kBig, inv1 ? py1 : -kBig),
                    fmaxf(inv0 ? pz0 : -kBig, inv1 ? pz1 : -kBig)};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        r[q] = warp_min(r[q]);
        r[3 + q] = warp_max(r[3 + q]);
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < 6; ++q) s_red[q][wid] = r[q];
      }
      __syncthreads();
      if (wid == 0) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          r[q] = warp_min(lane < kWarps ? s_red[q][lane] : kBig);
          r[3 + q] = warp_max(lane < kWarps ? s_red[3 + q][lane] : -kBig);
        }
        const int nl[3] = {rx / 8, ry / 8, rz / 8};
        int lo[3], hi[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = min(max(floor_div8((int)floorf(r[a])), 0), nl[a] - 1);
          hi[a] = min(max(floor_div8((int)floorf(r[3 + a])), 0), nl[a] - 1);
        }
        const bool has_v = r[0] <= r[3];
        const bool covered =
            hi[0] - lo[0] <= 2 && hi[1] - lo[1] <= 2 && hi[2] - lo[2] <= 2;
        // lane l < 27 loads window cell (l / 9, (l / 3) % 3, l % 3)
        float amin = kBig, amax = -kBig;
        const int xi = lo[0] + lane / 9, yi = lo[1] + (lane / 3) % 3,
                  zi = lo[2] + lane % 3;
        if (covered && lane < 27 && xi <= hi[0] && yi <= hi[1] &&
            zi <= hi[2]) {
          const int64_t m = ((int64_t)xi * nl[1] + yi) * nl[2] + zi;
          amin = __ldg(mip_mn + m);
          amax = __ldg(mip_mx + m);
        }
        amin = warp_min(amin);
        amax = warp_max(amax);
        if (lane == 0) {
          const bool is_skip = covered && amax <= -tdist;
          const bool is_const = covered && amin == amax;
          s_short = (!has_v || is_skip || is_const) ? 1 : 0;
          s_cval = is_skip ? -tdist : amin;
        }
      }
      __syncthreads();
      is_short = s_short;
      cval = s_cval;
    }

    // ---- exact trilerp of live (models/warp_field.py:_trilinear_c) -----
    if (has_pair) {
      float2 out = make_float2(cval, cval);
      if (!is_short) {
        out.x = trilerp_c32(live, rx, ry, rz, px0, py0, pz0);
        out.y = trilerp_c32(live, rx, ry, rz, px1, py1, pz1);
      }
      *(float2*)(vals + row) = out;
    }
  }
}

size_t ring_bytes(int brick, int k) {
  return 2 * sizeof(float) * (size_t)stage_words(brick * brick * brick, k);
}

bool args_ok(int brick, int C, int k) {
  return brick >= 2 && brick <= 8 && brick % 2 == 0 && C >= 1 &&
         C <= kMaxSlots && k >= 1 && k <= kMaxK;
}

}  // namespace

extern "C" int dfb_warp_trilerp_cached(
    const float* live, const float* node_dq, const int* cand, const int* sel,
    const float* selw, const float* lw, const float* mip_mn,
    const float* mip_mx, int use_mip, float tdist, int rx, int ry, int rz,
    int vy, int vz, int brick, int NB, int C, int k, int M, float* vals,
    unsigned char* valid, float* wx, float* wy, float* wz, void* stream) {
  if (!args_ok(brick, C, k) || M < 1) return (int)cudaErrorInvalidValue;
  if (NB > 0) {
    const size_t smem = ring_bytes(brick, k);
    const int grid = persistent_grid(warp_trilerp_cached_kernel, smem, NB);
    warp_trilerp_cached_kernel<<<grid, kPairThreads, smem,
                                 (cudaStream_t)stream>>>(
        live, node_dq, cand, sel, selw, lw, mip_mn, mip_mx, use_mip, tdist,
        rx, ry, rz, vy, vz, brick, NB, C, k, M, vals, valid, wx, wy, wz);
  }
  return (int)cudaGetLastError();
}

// out[6]: see trilerp.cuh:kernel_info
extern "C" int dfb_warp_trilerp_cached_info(int brick, int k, int* out) {
  if (!args_ok(brick, 1, k)) return (int)cudaErrorInvalidValue;
  return kernel_info(warp_trilerp_cached_kernel, ring_bytes(brick, k), out);
}
