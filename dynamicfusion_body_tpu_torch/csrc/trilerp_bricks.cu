// K4: trilerp of the live TSDF at given per-brick coordinates, one thread
// per sample.
//
// Replaces the TPU kernel
// dynamicfusion_body_tpu/ops/trilerp_pallas.py:trilerp_bricks (pallas_call
// body _kernel, with _box_mins and _interp_one). The TPU kernel stages a
// (16, 24, rz) box of live per group of bricks in VMEM and interpolates
// with one-hot bf16 matmuls; samples outside the box escape. Here the 8
// taps come straight from global memory with the formula of
// ops/interp.py:trilinear_c (trilerp.cuh, shared with K2 and K3), so no
// sample escapes and valid is exactly "inside the live volume". The
// coordinates are read as one flat array, so the (NB, V) brick layout, the
// group size and the precise/fast modes of the TPU kernel have no
// counterpart.
//
// Bound on this card: memory. Each sample reads 12 bytes of coordinates
// and writes 5 (value, valid); the taps of neighbouring samples of one
// brick share cache lines of live. At 256^3 (16.8 M samples) that is
// ~0.29 GB, ~0.09 ms at 3.35 TB/s plus the live cells tapped. Design:
// consecutive threads take consecutive samples, so coordinate and output
// traffic is coalesced; the taps go through the read-only cache.

#include "trilerp.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void trilerp_bricks_kernel(const float* __restrict__ live,
                                      const float* __restrict__ wx,
                                      const float* __restrict__ wy,
                                      const float* __restrict__ wz,
                                      long long n, int rx, int ry, int rz,
                                      float* __restrict__ vals,
                                      unsigned char* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = wx[i], py = wy[i], pz = wz[i];
  valid[i] = in_volume(px, py, pz, rx, ry, rz) ? 1 : 0;
  vals[i] = trilerp_c(live, rx, ry, rz, px, py, pz);
}

}  // namespace

extern "C" int dfb_trilerp_bricks(const float* live, const float* wx,
                                  const float* wy, const float* wz,
                                  long long n, int rx, int ry, int rz,
                                  float* vals, unsigned char* valid,
                                  void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    trilerp_bricks_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(live, wx, wy, wz, n, rx,
                                                    ry, rz, vals, valid);
  }
  return (int)cudaGetLastError();
}
