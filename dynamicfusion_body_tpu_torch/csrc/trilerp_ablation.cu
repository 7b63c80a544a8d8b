// K6: K4's trilerp taken apart, to split its time between the loads of the
// 8 taps and the weights, on rows of samples whose tap box is staged in
// shared memory.
//
// Replaces the TPU kernel tools/profile_trilerp.py:142 run (pallas_call at
// :143, body :64-139): K4's VMEM box kernel with pieces switched off. What
// each TPU variant isolates is ported:
//   loads   (for dma_only)    the row's box staged, K4's clamps and
//                             indices, the 8 taps read and their sum
//                             written in a fixed order (x fastest, then y,
//                             then z); no weights;
//   weights (for onehot_only) K4's index step and the 8 products
//                             (1-xd|xd)(1-yd|yd)(1-zd|zd), summed in the
//                             same order; nothing of live is read;
//   full    (for full_*pass_*) trilerp.cuh:trilerp_lerp's formula on the
//                             same taps, so the output is K4's vals bit
//                             for bit.
// The block size (128, 256, 512 threads) stands in for the TPU's group of
// bricks per grid step (8, 16). The bf16 pass count (1-3) and the tent or
// where form of the one-hot weights have no counterpart: K4 interpolates in
// f32 (-fmad=false) with no matrix unit. Both sums keep an output that
// depends on every value its mode computes, so the compiler can drop no
// tap load and no weight.
//
// Rows. A row is V <= kMaxRow consecutive samples, as the TPU kernel's
// (NB, V) blocks of one brick each; the wrapper passes V (the coordinates'
// last axis, or 512 for a 1-D input), and the last row may be shorter.
//
// Bound on this card: memory. Per sample the coordinates are 12 bytes read
// and the output 4 written; loads and full also read the live cells the
// taps touch. At 256^3 over the profiling tool's 16.8 M random samples
// (32768 rows of 512, each tapping at most 10 cells an axis) that is
// ~319 MB for loads and full (~0.095 ms at 3.35 TB/s; ~328 MB counted in
// whole 32-byte sectors) and ~268 MB for weights (~0.080 ms).
//
// Design. The first version ran one thread per sample over the flat arrays
// and gathered each sample's 8 taps from global memory: scattered 4-byte
// loads, a warp instruction touching up to ~32 cache lines, at 41% of the
// bound. Here, as the TPU kernel does with its VMEM box:
//  - persistent CTAs (as many as fit on the card) walk the rows
//    b = blockIdx.x + j * gridDim.x through a ring: while row j is
//    interpolated, row j+1's box and the coordinates of rows j+2 and j+3
//    are in flight;
//  - one thread asks the copy engine (the TMA) for everything a row needs:
//    three bulk copies of its coordinates and one 3-D tensor copy of its
//    box, both completing on mbarriers; the coordinates and the outputs
//    are evicted from L2 first, so that L2 keeps what it can of live. The
//    threads spend no instruction on copies: with 16-byte cp.async copies
//    of the box by every thread the kernel was issue-bound (as slow with
//    live resident in L2), and with one bulk copy a box row it waited on
//    the copy engine;
//  - the CTA reduces the row's clamped coordinates per axis (min and max by
//    warp reductions and one exchange) to the box of its taps; the row is
//    staged when the box fits the kBoxX x kBoxY x kBoxZ tile and no sample
//    lies on or past a far face of the volume, so that every upper tap is
//    i0 + 1 and the 8 taps sit at fixed offsets from the first;
//  - a staged row reads its taps from shared memory, one address and 8
//    loads with immediate offsets a sample; the others (samples outside
//    the volume, rows spread over it) read them from global memory through
//    the read-only cache, in the same kernel: a per-row path with the same
//    arithmetic, reported in the optional row_map (1 = staged);
//  - the index step runs with no conversion instruction (floor_nc);
//  - consecutive threads write consecutive outputs.
// What bounds it then is DRAM: a row's box is ~100 runs of 64 bytes, and
// rows whose bases are unrelated (the profiling tool's) find little of
// their box in L2, so ~260 MB of box sectors join the 268 MB of
// coordinates and outputs. Where live is not a TMA tensor (rz not a
// multiple of 4, or live not 16-byte aligned) the threads copy the box;
// where a row's coordinates are not whole 16-byte chunks the threads copy
// the rest. The weights mode runs the same frame without the boxes: it
// reduces no extent and writes no row_map.

#include <cuda.h>  // CUtensorMap and the encoder's types; the encoder is
                   // reached through the runtime, so nothing links libcuda
#include <limits.h>
#include <math.h>

#include "trilerp.cuh"

namespace {

constexpr int kLoads = 0, kWeights = 1, kFull = 2;
constexpr int kMaxRow = 512;        // samples in a row at most
constexpr int kMaxAxis = 1 << 22;  // cells an axis at most (floor_nc)
// the staged box, one TMA tile: x, y, z extents (z fastest), from an
// origin whose z is a multiple of 4 (the TMA faults on a tile whose first
// z is not 16-byte aligned, measured on the H100); 6400 bytes, a multiple
// of the 128 the TMA aligns its tiles to
constexpr int kBoxX = 10, kBoxY = 10, kBoxZ = 16;
constexpr int kBoxWords = kBoxX * kBoxY * kBoxZ;
constexpr int kPitchX = kBoxY * kBoxZ;
constexpr int kTileWords = (kBoxWords + 31) & ~31;
// ring stages: coordinates of rows j .. j+3, boxes of rows j, j+1
constexpr int kCoordStages = 4, kBoxStages = 2;

// CTAs per SM each block size's register budget is built for: the most
// that compile without a spill (40 registers), which is also what shared
// memory allows (~38 KB a CTA with its reserve at V = 512)
#define DFB_K6_MIN_BLOCKS(threads) ((threads) == 512 ? 3 : 6)

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// dynamic shared memory of a CTA, in 4-byte words: the box ring, then the
// coordinate ring (x, y and z rows of round4(V) words each), and 128 bytes
// to align the tiles as the TMA needs
__host__ __device__ __forceinline__ int ring_words(int V) {
  return kBoxStages * kTileWords + kCoordStages * 3 * round4(V) + 32;
}

struct Args {
  CUtensorMap box;  // live as a (z, y, x) tensor, tiles of the box's size
  const float* live;
  const float* wx;
  const float* wy;
  const float* wz;
  long long n;  // samples
  int V, n_rows, rx, ry, rz;
  float hx, hy, hz;  // rx - 1, ry - 1, rz - 1
  int cvec;  // coordinates by bulk copies (V % 4 == 0, 16-byte aligned)
  int tma;   // boxes by the TMA (box encoded)
  float* out;
  unsigned char* row_map;  // n_rows flags, or null
};

// A row's box: its origin (the least i0 an axis, z rounded down to a
// multiple of 4), staged when its taps fit the tile from there with every
// upper tap at i0 + 1.
struct Box {
  int ox, oy, oz, staged;
};

// ---- the copy engine: bulk and tensor copies, mbarriers -----------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the barrier's one arrival for a phase, which also expects `bytes` of
// copies (0: none) before the phase completes
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// waits until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the L2 policy of the streams read or written once (coordinates,
// outputs): evicted first
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar,
                                          unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// the tile of map at cell (x, y, z) to shared dst (128-byte aligned),
// counted on bar; cells past the tensor's end read as 0
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int x, int y, int z,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"((unsigned long long)map), "r"(z), "r"(y), "r"(x),
      "r"(smem_addr(bar))
      : "memory");
}

// one output, evicted from L2 first
__device__ __forceinline__ void store_hint(float* p, float v,
                                           unsigned long long policy) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;\n" ::"l"(p),
               "f"(v), "l"(policy)
               : "memory");
}

// ---- the index step ------------------------------------------------------

// f + 2^23 rounded down, for 0 <= f < 2^23: floor(f) + 2^23 exactly, so
// its bits less those of 2^23 are floor(f) and it less 2^23 is floor(f) as
// a float; no conversion instruction (F2I and FRND issue at an eighth of
// the FADD rate)
__device__ __forceinline__ float floor_biased(float f) {
  return __fadd_rd(f, 8388608.f);
}

__device__ __forceinline__ float floor_nc(float f, int& i) {
  const float t = floor_biased(f);
  i = __float_as_int(t) - 0x4B000000;
  return t - 8388608.f;
}

// trilerp.cuh:trilerp_index with floor_nc: the same indices and fractions
// for volumes whose axes are shorter than 2^23 cells (the wrapper checks)
__device__ __forceinline__ TrilerpIdx box_index(const Args& a, float px,
                                                float py, float pz) {
  const float fx = fminf(fmaxf(px, 0.f), a.hx);
  const float fy = fminf(fmaxf(py, 0.f), a.hy);
  const float fz = fminf(fmaxf(pz, 0.f), a.hz);
  TrilerpIdx t;
  t.xd = fx - floor_nc(fx, t.x0);
  t.yd = fy - floor_nc(fy, t.y0);
  t.zd = fz - floor_nc(fz, t.z0);
  t.x1 = min(t.x0 + 1, a.rx - 1);
  t.y1 = min(t.y0 + 1, a.ry - 1);
  t.z1 = min(t.z0 + 1, a.rz - 1);
  return t;
}

__device__ __forceinline__ int row_len(const Args& a, int b) {
  const long long r = a.n - (long long)b * a.V;
  return r < a.V ? (int)r : a.V;
}

// row b's x, y, z coordinate rows into stage (rows of round4(V) words),
// counted on bar: where the arrays allow (cvec), one thread asks for three
// bulk copies of the row's whole 16-byte chunks, and the threads copy a
// short last row's remaining 1-3 samples an array; otherwise the threads
// copy every sample. The barrier's phase completes when the bulk copies
// land; the threads' own copies are seen after the next __syncthreads().
template <int kThreads>
__device__ __forceinline__ void fetch_coords(float* stage, const Args& a,
                                             int b, unsigned long long* bar,
                                             unsigned long long policy) {
  const long long s0 = (long long)b * a.V;
  const int L = row_len(a, b), Vp = round4(a.V);
  const int whole = a.cvec ? L & ~3 : 0;  // samples by bulk copy
  if (threadIdx.x == 0) {
    mbar_arrive(bar, 3 * 4 * whole);
    if (whole > 0) {
      bulk_copy(stage, a.wx + s0, 4 * whole, bar, policy);
      bulk_copy(stage + Vp, a.wy + s0, 4 * whole, bar, policy);
      bulk_copy(stage + 2 * Vp, a.wz + s0, 4 * whole, bar, policy);
    }
  }
  const int rest = L - whole;
#pragma unroll 1
  for (int c = threadIdx.x; c < 3 * rest; c += kThreads) {
    const int k = c >= rest ? (c >= 2 * rest ? 2 : 1) : 0;
    const int e = whole + c - k * rest;
    stage[k * Vp + e] = __ldg((k == 0 ? a.wx : k == 1 ? a.wy : a.wz) + s0 + e);
  }
}

// The box of the L samples whose coordinates are in stage: the least and
// greatest clamped coordinate an axis (clamp and floor are monotone, so
// their floors are the least and greatest i0), reduced over the CTA by warp
// reductions and one exchange through s_part. Every thread returns the
// same Box. Holds a __syncthreads(): the whole CTA calls it.
template <int kThreads>
__device__ __forceinline__ Box row_box(const float* stage, int Vp, int L,
                                       const Args& a, int* s_part) {
  constexpr int kWarps = kThreads / 32;
  // fmaxf(p, 0) maps NaN to 0, as the index step does
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int s = threadIdx.x; s < L; s += kThreads) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float c = fmaxf(stage[q * Vp + s], 0.f);
      lo[q] = fminf(lo[q], c);
      hi[q] = fmaxf(hi[q], c);
    }
  }
  const float h[3] = {a.hx, a.hy, a.hz};
  // non-negative floats order as their bits (a -0 as +0), so the integer
  // reductions order them
  int m[6];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    m[q] = __reduce_min_sync(~0u,
                             max(__float_as_int(fminf(lo[q], h[q])), 0));
    m[3 + q] = __reduce_max_sync(~0u,
                                 max(__float_as_int(fminf(hi[q], h[q])), 0));
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) s_part[q * kWarps + wid] = m[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    floor_nc(__int_as_float(__reduce_min_sync(
                 ~0u, lane < kWarps ? s_part[q * kWarps + lane] : INT_MAX)),
             m[q]);
    floor_nc(__int_as_float(__reduce_max_sync(
                 ~0u, lane < kWarps ? s_part[(3 + q) * kWarps + lane] : 0)),
             m[3 + q]);
  }
  // the taps span [lo, hi + 1] an axis when hi <= r - 2; the box starts
  // at lo, its z rounded down to a multiple of 4
  m[2] &= ~3;
  const int r[3] = {a.rx, a.ry, a.rz}, box[3] = {kBoxX, kBoxY, kBoxZ};
  bool staged = true;
#pragma unroll
  for (int q = 0; q < 3; ++q)
    staged = staged && m[3 + q] <= r[q] - 2 && m[3 + q] - m[q] + 2 <= box[q];
  return Box{m[0], m[1], m[2], staged};
}

// a row's box into the tile (x pitch kPitchX, y pitch kBoxZ), counted on
// bar: one thread asks the TMA for the tile at the box's origin, or, where
// live is no TMA tensor, the threads copy the tile's cells inside the
// volume (seen after the next __syncthreads()). A row that is not staged
// copies nothing, and its phase completes at once.
template <int kThreads>
__device__ __forceinline__ void fetch_box(float* tile, const Args& a,
                                          const Box& r,
                                          unsigned long long* bar) {
  if (threadIdx.x == 0) {
    mbar_arrive(bar, r.staged && a.tma ? 4 * kBoxWords : 0);
    if (r.staged && a.tma) tensor_copy(tile, &a.box, r.ox, r.oy, r.oz, bar);
  }
  if (r.staged && !a.tma) {
#pragma unroll 1
    for (int c = threadIdx.x; c < kBoxWords; c += kThreads) {
      const int x = c / kPitchX, y = (c - x * kPitchX) / kBoxZ,
                z = c - x * kPitchX - y * kBoxZ;
      if (r.ox + x < a.rx && r.oy + y < a.ry && r.oz + z < a.rz)
        tile[c] = __ldg(a.live +
                        ((long long)(r.ox + x) * a.ry + (r.oy + y)) * a.rz +
                        r.oz + z);
    }
  }
}

// One sample's value from its 8 taps at p + {0, dx} + {0, dy} + {0, dz}
// (p in shared memory, or in global memory read through the read-only
// cache): their sum (loads) or trilerp_lerp's formula (full).
template <int kMode, bool kShared>
__device__ __forceinline__ float from_taps(const float* __restrict__ p,
                                           int dx, int dy, int dz, float xd,
                                           float yd, float zd) {
  auto g = [&](int o) { return kShared ? p[o] : __ldg(p + o); };
  if (kMode == kFull) {
    const float c00 = g(0) * (1.f - xd) + g(dx) * xd;
    const float c01 = g(dy) * (1.f - xd) + g(dx + dy) * xd;
    const float c10 = g(dz) * (1.f - xd) + g(dx + dz) * xd;
    const float c11 = g(dy + dz) * (1.f - xd) + g(dx + dy + dz) * xd;
    const float c0 = c00 * (1.f - yd) + c01 * yd;
    const float c1 = c10 * (1.f - yd) + c11 * yd;
    return c0 * (1.f - zd) + c1 * zd;
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float term =
        g((c & 1 ? dx : 0) + ((c >> 1) & 1 ? dy : 0) + (c >> 2 ? dz : 0));
    s = c == 0 ? term : s + term;
  }
  return s;
}

template <int kMode, int kThreads>
__global__ void __launch_bounds__(kThreads, DFB_K6_MIN_BLOCKS(kThreads))
    trilerp_ablation_kernel(const __grid_constant__ Args a) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) float s_dyn[];
  __shared__ int s_part[6 * kWarps];
  __shared__ Box s_box[kBoxStages];
  // one mbarrier a ring stage: coordinates, then boxes
  __shared__ __align__(8) unsigned long long s_bar[kCoordStages +
                                                   kBoxStages];

  const int tid = threadIdx.x, G = gridDim.x, Vp = round4(a.V);
  // the tiles from the first 128-byte boundary (the TMA's alignment)
  float* const s_tiles = s_dyn + ((128 - (smem_addr(s_dyn) & 127)) & 127) / 4;
  float* const s_coords = s_tiles + kBoxStages * kTileWords;
  unsigned long long* const cbar = s_bar;
  unsigned long long* const bbar = s_bar + kCoordStages;
  const int cwords = 3 * Vp;
  const int plane = a.ry * a.rz;
  const unsigned long long stream = evict_first_policy();
  // this CTA's rows are j = 0, 1, ...: row blockIdx.x + j G. Row j's
  // coordinates go to stage j % kCoordStages (its barrier's phase
  // j / kCoordStages), kAheadC steps ahead of its taps; its box to stage
  // j % kBoxStages (phase j / kBoxStages), one step ahead
  constexpr int kAheadC = kCoordStages - 1;
  const int n_mine = (a.n_rows - blockIdx.x + G - 1) / G;
  auto row = [&](int j) { return blockIdx.x + j * G; };
  auto coords_of = [&](int j) {
    return s_coords + (j % kCoordStages) * cwords;
  };
  // row j's box reduced, its flag written and its tile asked for (the
  // weights mode stages nothing); the CTA calls it together
  auto stage_box = [&](int j) {
    if (kMode == kWeights) return;
    const Box r = row_box<kThreads>(coords_of(j), Vp, row_len(a, row(j)), a,
                                    s_part);
    if (tid == 0) {
      s_box[j % kBoxStages] = r;
      if (a.row_map) a.row_map[row(j)] = (unsigned char)r.staged;
    }
    fetch_box<kThreads>(s_tiles + (j % kBoxStages) * kTileWords, a, r,
                        bbar + j % kBoxStages);
  };

  if (tid == 0) {
    for (int k = 0; k < kCoordStages + kBoxStages; ++k) mbar_init(s_bar + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // prologue: coordinates of rows 0 .. kAheadC - 1, row 0's box
  for (int j = 0; j < kAheadC && j < n_mine; ++j)
    fetch_coords<kThreads>(coords_of(j), a, row(j), cbar + j, stream);
  mbar_wait(cbar, 0);
  __syncthreads();
  stage_box(0);

  for (int j = 0; j < n_mine; ++j) {
    const int b = row(j), bs = j % kBoxStages;
    // row j's box and row j+1's coordinates landed; the threads' own
    // copies are seen after the barrier
    if (kMode != kWeights) mbar_wait(bbar + bs, (j / kBoxStages) & 1);
    if (j + 1 < n_mine)
      mbar_wait(cbar + (j + 1) % kCoordStages,
                ((j + 1) / kCoordStages) & 1);
    __syncthreads();
    if (j + 1 < n_mine) stage_box(j + 1);
    if (j + kAheadC < n_mine)
      fetch_coords<kThreads>(coords_of(j + kAheadC), a, row(j + kAheadC),
                             cbar + (j + kAheadC) % kCoordStages, stream);

    // ---- row j ----------------------------------------------------------
    const float* cx = coords_of(j);
    const float* cy = cx + Vp;
    const float* cz = cy + Vp;
    const int L = row_len(a, b);
    float* const out = a.out + (long long)b * a.V;
    if (kMode == kWeights) {
#pragma unroll 1
      for (int s = tid; s < L; s += kThreads) {
        const TrilerpIdx t = box_index(a, cx[s], cy[s], cz[s]);
        const float ax[2] = {1.f - t.xd, t.xd}, ay[2] = {1.f - t.yd, t.yd},
                    az[2] = {1.f - t.zd, t.zd};
        float w = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float term = ax[c & 1] * ay[(c >> 1) & 1] * az[c >> 2];
          w = c == 0 ? term : w + term;
        }
        store_hint(out + s, w, stream);
      }
    } else if (s_box[bs].staged) {
      // every upper tap is i0 + 1: the 8 taps at fixed offsets from the
      // first, whose offset comes from the biased floors' bits (wrapping
      // 32-bit arithmetic; the result lies in the tile)
      const Box r = s_box[bs];
      const float* tile = s_tiles + bs * kTileWords;
      const unsigned base = 0u - 0x4B000000u * (kPitchX + kBoxZ + 1) -
                            (unsigned)(r.ox * kPitchX + r.oy * kBoxZ + r.oz);
#pragma unroll 1
      for (int s = tid; s < L; s += kThreads) {
        const float fx = fminf(fmaxf(cx[s], 0.f), a.hx);
        const float fy = fminf(fmaxf(cy[s], 0.f), a.hy);
        const float fz = fminf(fmaxf(cz[s], 0.f), a.hz);
        const float bx = floor_biased(fx), by = floor_biased(fy),
                    bz = floor_biased(fz);
        const unsigned o = __float_as_uint(bx) * kPitchX +
                           __float_as_uint(by) * kBoxZ +
                           __float_as_uint(bz) + base;
        store_hint(out + s,
                   from_taps<kMode, true>(tile + o, kPitchX, kBoxZ, 1,
                                          fx - (bx - 8388608.f),
                                          fy - (by - 8388608.f),
                                          fz - (bz - 8388608.f)),
                   stream);
      }
    } else {
#pragma unroll 1
      for (int s = tid; s < L; s += kThreads) {
        const TrilerpIdx t = box_index(a, cx[s], cy[s], cz[s]);
        const float* p =
            a.live + (long long)t.x0 * plane + (t.y0 * a.rz + t.z0);
        store_hint(out + s,
                   from_taps<kMode, false>(p, (t.x1 - t.x0) * plane,
                                           (t.y1 - t.y0) * a.rz, t.z1 - t.z0,
                                           t.xd, t.yd, t.zd),
                   stream);
      }
    }
  }
}

using Kernel = void (*)(Args);

template <int kMode>
Kernel by_threads(int threads) {
  switch (threads) {
    case 128: return trilerp_ablation_kernel<kMode, 128>;
    case 256: return trilerp_ablation_kernel<kMode, 256>;
    case 512: return trilerp_ablation_kernel<kMode, 512>;
    default: return nullptr;
  }
}

Kernel kernel_for(int mode, int threads) {
  switch (mode) {
    case kLoads: return by_threads<kLoads>(threads);
    case kWeights: return by_threads<kWeights>(threads);
    case kFull: return by_threads<kFull>(threads);
    default: return nullptr;
  }
}

// CTAs of `threads` threads and `smem` dynamic bytes that fit on an SM
int ctas_per_sm(Kernel kernel, int threads, size_t smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kernel,
                                                threads, smem);
  return per_sm > 0 ? per_sm : 1;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// live (rx, ry, rz) as a TMA tensor of tiles of the box's size: false where
// the TMA cannot read it (rz * 4 not a multiple of 16, live not 16-byte
// aligned) or the driver has no encoder
bool encode_box(CUtensorMap* map, const float* live, int rx, int ry,
                int rz) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return (Encode)fn;
  }();
  if (encode == nullptr || rz % 4 != 0 || ((uintptr_t)live & 15) != 0)
    return false;

  const cuuint64_t dims[3] = {(cuuint64_t)rz, (cuuint64_t)ry,
                              (cuuint64_t)rx};
  const cuuint64_t strides[2] = {(cuuint64_t)rz * 4,
                                 (cuuint64_t)ry * rz * 4};
  const cuuint32_t tile[3] = {kBoxZ, kBoxY, kBoxX}, step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)live, dims,
                strides, tile, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// mode: 0 loads, 1 weights, 2 full; threads: 128, 256 or 512 per CTA; n
// samples in rows of V (1 <= V <= 512; the last row may be shorter);
// row_map: n_rows = ceil(n / V) flags (1 = the row's box was staged), or
// null (always null in the weights mode, which stages nothing). The
// volume's axes must be at most 2^22 cells and its planes hold fewer than
// 2^31 (ry * rz).
extern "C" int dfb_trilerp_ablation(int mode, int threads, const float* live,
                                    const float* wx, const float* wy,
                                    const float* wz, long long n, int V,
                                    int rx, int ry, int rz, float* out,
                                    unsigned char* row_map, void* stream) {
  const Kernel kernel = kernel_for(mode, threads);
  if (kernel == nullptr || V < 1 || V > kMaxRow ||
      (long long)ry * rz > INT_MAX || rx > kMaxAxis || ry > kMaxAxis ||
      rz > kMaxAxis || (mode == kWeights && row_map != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const long long rows = (n + V - 1) / V;
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  Args a{};
  a.live = live;
  a.wx = wx;
  a.wy = wy;
  a.wz = wz;
  a.n = n;
  a.V = V;
  a.n_rows = (int)rows;
  a.rx = rx;
  a.ry = ry;
  a.rz = rz;
  a.hx = rx - 1.f;
  a.hy = ry - 1.f;
  a.hz = rz - 1.f;
  a.cvec = V % 4 == 0 && aligned(wx) && aligned(wy) && aligned(wz);
  a.tma = mode != kWeights && encode_box(&a.box, live, rx, ry, rz);
  a.out = out;
  a.row_map = row_map;
  const size_t smem = ring_words(V) * sizeof(float);  // < 48 KB
  const long long g =
      (long long)ctas_per_sm(kernel, threads, smem) * sm_count();
  const unsigned grid = (unsigned)(g < rows ? g : rows);
  void* params[] = {&a};
  return (int)cudaLaunchKernel((const void*)kernel, dim3(grid),
                               dim3(threads), params, smem,
                               (cudaStream_t)stream);
}

// out[6]: registers, local (spill) bytes per thread, threads per CTA, CTAs
// per SM, the persistent grid for an unbounded row count, dynamic shared
// bytes, of the (mode, threads) instantiation at rows of V samples
extern "C" int dfb_trilerp_ablation_info(int mode, int threads, int V,
                                         int* out) {
  const Kernel kernel = kernel_for(mode, threads);
  if (kernel == nullptr || V < 1 || V > kMaxRow)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, (const void*)kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ring_words(V) * sizeof(float);  // < 48 KB
  const int per_sm = ctas_per_sm(kernel, threads, smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = threads;
  out[3] = per_sm;
  out[4] = per_sm * sm_count();
  out[5] = (int)smem;
  return (int)cudaGetLastError();
}
