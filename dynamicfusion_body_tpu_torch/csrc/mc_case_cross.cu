// K1: fused marching-cubes front end.
//
// Replaces the TPU kernel dynamicfusion_body_tpu/ops/mc_pallas.py:mc_case_cross
// (pallas_call body _kernel). Per lattice cell (i,j,k) of an (X,Y,Z) f32
// volume it writes one int32:
//   bits 0..7  the MC case byte, corner bit b at (b&1, b>>1&1, b>>2&1),
//              0 on the dead last plane of each axis;
//   bit 8/9/10 the x/y/z edge-crossing flag (v<level) != (v_next<level),
//              0 on the last plane of that axis.
//
// Bound on this card: memory. Each voxel is read once and each word written
// once: 64 MB in + 64 MB out at 256^3, 0.040 ms at 3.35 TB/s.
// Design: a sliding window along x. A CTA owns a column of kRowsY y-rows by
// kTileZ z-cells and walks a chunk of x-planes. Each thread owns a run of
// kRun z-cells of one row: it reads its run of plane i+1 once (one 16-byte
// load where the layout allows, two for the stride-2 view; the loads of
// planes i+2 and i+3 are in flight while plane i is written), turns it
// into inside bits, and keeps plane i's bits from the step before. The
// grid is one wave of CTAs; each walks a chunk of planes and re-reads the
// plane after its chunk. The +1 halo in z comes from the next lane by a
// shuffle (the warp's last lane reads one more voxel), the +1 halo in y from
// the next warp's bits in shared memory (one more warp reads the row past
// the tile). Plane i's words go out as one 16-byte store. The volume comes
// with its element strides, so the stride-2 extraction reads vol[::2,::2,::2]
// where it lies, without a copy. All index math is 32-bit: the wrapper
// refuses volumes whose offsets reach 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 4;                // z-cells per thread
constexpr int kTileZ = 32 * kRun;      // z-cells per CTA (one warp wide)
constexpr int kRowsY = 8;              // y-rows written per CTA
constexpr int kWarps = kRowsY + 1;     // + the warp that reads the y halo
constexpr int kThreads = 32 * kWarps;
constexpr int kMinCtas = 5;            // at most 40 registers a thread

// How a run is read: kScalar one element at a time (any strides),
// kVec4 one 16-byte load (z-stride 1), kVec8 two 16-byte loads of which
// the even elements are the run (z-stride 2: the stride-2 extraction; the
// second load reads one element past the run, which the wrapper checks the
// storage holds)
enum Mode { kVec4, kVec8, kScalar };

struct Run {
  float4 v;    // the run's kRun voxels
  float halo;  // the voxel after the run (the warp's last lane only)
};

// Reads plane i of this thread's run; voxels outside the volume are never
// read and come out as level, which is not inside.
template <int kMode>
__device__ __forceinline__ Run load_run(const float* __restrict__ vol, int i,
                                        int j, int k, int X, int Y, int Z,
                                        int sx, int sy, int sz, float level,
                                        bool last_lane) {
  Run r{make_float4(level, level, level, level), level};
  if (i >= X || j >= Y || k >= Z) return r;
  const float* p = vol + (i * sx + j * sy + k * sz);
  if (kMode == kVec4) {  // sz == 1, Z % 4 == 0, 16-byte aligned rows
    r.v = __ldcs(reinterpret_cast<const float4*>(p));
  } else if (kMode == kVec8) {  // sz == 2, Z % 4 == 0, aligned rows
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    r.v = make_float4(a.x, a.z, b.x, b.z);
  } else {
    r.v.x = __ldcs(p);
    if (k + 1 < Z) r.v.y = __ldcs(p + sz);
    if (k + 2 < Z) r.v.z = __ldcs(p + 2 * sz);
    if (k + 3 < Z) r.v.w = __ldcs(p + 3 * sz);
  }
  if (last_lane && k + kRun < Z) r.halo = __ldg(p + kRun * sz);
  return r;
}

// Bit r (r < kRun) = voxel k+r inside, bit kRun = voxel k+kRun inside (from
// the next lane's bit 0, or the last lane's halo voxel). Every lane of the
// warp calls it (the shuffle).
__device__ __forceinline__ uint32_t run_bits(const Run& r, float level,
                                             int lane) {
  const uint32_t b = (uint32_t)(r.v.x < level) |
                     ((uint32_t)(r.v.y < level) << 1) |
                     ((uint32_t)(r.v.z < level) << 2) |
                     ((uint32_t)(r.v.w < level) << 3);
  const uint32_t next = __shfl_down_sync(0xffffffffu, b, 1) & 1u;
  const uint32_t h = lane == 31 ? (uint32_t)(r.halo < level) : next;
  return b | (h << kRun);
}

// The four 4-bit corner groups of cell r: bit 0 plane i row j, bit 1 plane
// i+1 row j, bit 2 plane i row j+1, bit 3 plane i+1 row j+1, all at z-cell
// r. `bytes` holds the four 5-bit run masks in its four bytes; the multiply
// gathers bit r of each byte into bits 24..27 without carries.
__device__ __forceinline__ uint32_t corner_nibble(uint32_t bytes, int r) {
  return (((bytes >> r) & 0x01010101u) * 0x01020408u) >> 24;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinCtas) mc_case_cross_kernel(
    const float* __restrict__ vol, int* __restrict__ out, int X, int Y, int Z,
    int sx, int sy, int sz, int chunk, float level) {
  __shared__ uint8_t rows[2][kWarps][32];  // run masks, double-buffered
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int k = blockIdx.x * kTileZ + lane * kRun;
  const int j = blockIdx.y * kRowsY + wy;
  const int i_begin = blockIdx.z * chunk;
  const int i_end = min(i_begin + chunk, X);
  const bool last_lane = lane == 31;
  const bool writer = wy < kRowsY && j < Y && k < Z;
  const bool vy = j < Y - 1;
  auto load = [&](int i) {
    return load_run<kMode>(vol, i, j, k, X, Y, Z, sx, sy, sz, level,
                           last_lane);
  };

  // planes i+1 and i+2 are in flight while plane i is written
  Run nxt1 = load(i_begin);
  uint32_t prev = run_bits(nxt1, level, lane);
  rows[0][wy][lane] = (uint8_t)prev;
  nxt1 = load(i_begin + 1);
  Run nxt2 = load(i_begin + 2);
  __syncthreads();
  uint32_t prev1 = wy < kRowsY ? rows[0][wy + 1][lane] : 0u;

  for (int i = i_begin; i < i_end; ++i) {
    const int buf = (i - i_begin + 1) & 1;
    const uint32_t cur = run_bits(nxt1, level, lane);  // plane i+1
    nxt1 = nxt2;
    nxt2 = load(i + 3);
    rows[buf][wy][lane] = (uint8_t)cur;
    __syncthreads();
    const uint32_t cur1 = wy < kRowsY ? rows[buf][wy + 1][lane] : 0u;

    if (writer) {
      const bool vx = i < X - 1;
      const uint32_t bytes = prev | (cur << 8) | (prev1 << 16) | (cur1 << 24);
      const uint32_t cx = vx ? prev ^ cur : 0u;
      const uint32_t cy = vy ? prev ^ prev1 : 0u;
      const uint32_t cz = prev ^ (prev >> 1);
      int word[kRun];
      uint32_t lo = corner_nibble(bytes, 0);
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const uint32_t hi = corner_nibble(bytes, r + 1);
        const bool vz = k + r < Z - 1;
        const uint32_t code = vx && vy && vz ? lo | (hi << 4) : 0u;
        word[r] = (int)(code | (((cx >> r) & 1u) << 8) |
                        (((cy >> r) & 1u) << 9) |
                        ((vz ? (cz >> r) & 1u : 0u) << 10));
        lo = hi;
      }
      int* o = out + ((i * Y + j) * Z + k);
      if (kMode != kScalar) {  // Z % 4 == 0
        __stcs(reinterpret_cast<int4*>(o),
               make_int4(word[0], word[1], word[2], word[3]));
      } else {
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
          if (k + r < Z) __stcs(o + r, word[r]);
        }
      }
    }
    prev = cur;
    prev1 = cur1;
  }
}

using Kernel = void (*)(const float*, int*, int, int, int, int, int, int,
                        int, float);

// The instantiations, by Mode: 16-byte loads and stores (z-stride 1, the
// live MC), two 16-byte loads and one store a run (z-stride 2, the
// canonical MC), element loads and stores (any other strides or Z)
constexpr int kKernels = 3;
Kernel kernel_at(int which) {
  switch (which) {
    case kVec4: return mc_case_cross_kernel<kVec4>;
    case kVec8: return mc_case_cross_kernel<kVec8>;
    default: return mc_case_cross_kernel<kScalar>;
  }
}

// CTAs the card holds at once for each instantiation (asked once)
int capacity(int which) {
  static int cached[kKernels] = {0, 0, 0};
  if (cached[which] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_at(which),
                                                  kThreads, 0);
    cached[which] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[which];
}

}  // namespace

// tail: 1 if the volume's storage holds an element past its last one (the
// stride-2 loads read one), else 0
extern "C" int dfb_mc_case_cross(const float* vol, int* out, int X, int Y,
                                 int Z, int sx, int sy, int sz, int tail,
                                 float level, void* stream) {
  if (X < 1 || Y < 1 || Z < 1) return (int)cudaGetLastError();
  const bool rows16 = Z % kRun == 0 && sy % kRun == 0 && sx % kRun == 0 &&
                      (uintptr_t)vol % 16 == 0;
  const int which = rows16 && sz == 1               ? kVec4
                    : rows16 && sz == 2 && tail > 0 ? kVec8
                                                    : kScalar;
  // one wave of CTAs, each walking a chunk of x-planes (a chunk re-reads
  // the plane after it)
  const int tiles_z = (Z + kTileZ - 1) / kTileZ;
  const int tiles_y = (Y + kRowsY - 1) / kRowsY;
  const int cap = capacity(which);
  const int n_chunks = max(1, min(X, cap / (tiles_z * tiles_y)));
  const int chunk = (X + n_chunks - 1) / n_chunks;
  const dim3 grid(tiles_z, tiles_y, (X + chunk - 1) / chunk);
  kernel_at(which)<<<grid, dim3(32, kWarps), 0, (cudaStream_t)stream>>>(
      vol, out, X, Y, Z, sx, sy, sz, chunk, level);
  return (int)cudaGetLastError();
}

// out[6]: registers, local (spill) bytes per thread, threads per CTA, CTAs
// per SM, static shared bytes, and 0 (no persistent grid) for
// instantiation `which` (see kernel_at)
extern "C" int dfb_mc_case_cross_info(int which, int* out) {
  if (which < 0 || which >= kKernels) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_at(which);
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
