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
// Bound on this card: memory. Each cell reads its own 4 B voxel and writes
// 4 B; the 7 neighbour reads of a cell are the own-voxel reads of adjacent
// threads and hit L1/L2. At 256^3 that is 64 MB in + 64 MB out.
// Design: one thread per cell, z fastest, so a warp reads and writes 32
// consecutive words; no shared memory, no halo logic — the clamp at the
// last plane replaces the TPU kernel's slab halo block. Any X,Y,Z >= 2.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mc_case_cross_kernel(const float* __restrict__ vol,
                                     int* __restrict__ out, int X, int Y,
                                     int Z, float level) {
  const int64_t n = (int64_t)X * Y * Z;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int k = (int)(idx % Z);
  const int64_t t = idx / Z;
  const int j = (int)(t % Y);
  const int i = (int)(t / Y);
  const int64_t sx = (int64_t)Y * Z;
  const int64_t sy = Z;

  const bool vx = i < X - 1, vy = j < Y - 1, vz = k < Z - 1;
  const int dx = vx ? 1 : 0, dy = vy ? 1 : 0, dz = vz ? 1 : 0;
  // inside bit of the corner at offset (a, b, c), clamped at the last plane
  auto ins = [&](int a, int b, int c) -> int {
    return __ldg(vol + idx + a * dx * sx + b * dy * sy + c * dz) < level;
  };
  const int c0 = ins(0, 0, 0);
  int code = 0;
  if (vx && vy && vz) {
    for (int b = 0; b < 8; ++b) {
      code |= ins(b & 1, (b >> 1) & 1, (b >> 2) & 1) << b;
    }
  }
  if (vx) code |= (c0 ^ ins(1, 0, 0)) << 8;
  if (vy) code |= (c0 ^ ins(0, 1, 0)) << 9;
  if (vz) code |= (c0 ^ ins(0, 0, 1)) << 10;
  out[idx] = code;
}

extern "C" int dfb_mc_case_cross(const float* vol, int* out, int X, int Y,
                                 int Z, float level, void* stream) {
  const int64_t n = (int64_t)X * Y * Z;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (n > 0) {
    mc_case_cross_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(vol, out, X, Y, Z, level);
  }
  return (int)cudaGetLastError();
}
