// K6: K4's trilerp taken apart, to split its time between the loads of the
// 8 taps and the weights, one thread per sample over the flat coordinates
// as in K4 (trilerp_bricks.cu).
//
// Replaces the TPU kernel tools/profile_trilerp.py:142 run (pallas_call at
// :143, body :64-139): K4's VMEM box kernel with pieces switched off. What
// each TPU variant isolates is ported, not its mechanism:
//   loads   (for dma_only)    K4's clamps and indices, the 8 taps read
//                             through __ldg, their sum written in a fixed
//                             order (x fastest, then y, then z); no weights;
//   weights (for onehot_only) K4's index step and the 8 products
//                             (1-xd|xd)(1-yd|yd)(1-zd|zd), summed in the
//                             same order; nothing of live is read;
//   full    (for full_*pass_*) trilerp_c, so the output is K4's vals bit
//                             for bit.
// The block size (128, 256, 512 threads) stands in for the TPU's group of
// bricks per grid step (8, 16). The bf16 pass count (1-3) and the tent or
// where form of the one-hot weights have no counterpart: K4 interpolates in
// f32 (-fmad=false) with no matrix unit. Both sums keep an output that
// depends on every value its mode computes, so the compiler can drop no
// tap load and no weight.
//
// Bound on this card: memory. Per sample the coordinates are 12 bytes read
// and the output 4 written; loads and full also read the live cells the
// taps touch. At 256^3 over the profiling tool's 16.8 M random samples
// that is ~335 MB for loads and full (~0.100 ms at 3.35 TB/s) and ~268 MB
// for weights (~0.080 ms). Design: consecutive threads take consecutive
// samples, so coordinate and output traffic is coalesced; the taps go
// through the read-only cache.

#include "trilerp.cuh"

namespace {

constexpr int kLoads = 0, kWeights = 1, kFull = 2;

template <int kMode, int kThreads>
__global__ void __launch_bounds__(kThreads)
    trilerp_ablation_kernel(const float* __restrict__ live,
                            const float* __restrict__ wx,
                            const float* __restrict__ wy,
                            const float* __restrict__ wz, long long n, int rx,
                            int ry, int rz, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float px = wx[i], py = wy[i], pz = wz[i];
  if (kMode == kFull) {
    out[i] = trilerp_c(live, rx, ry, rz, px, py, pz);
    return;
  }
  const TrilerpIdx t = trilerp_index(rx, ry, rz, px, py, pz);
  const int xs[2] = {t.x0, t.x1}, ys[2] = {t.y0, t.y1}, zs[2] = {t.z0, t.z1};
  const float ax[2] = {1.f - t.xd, t.xd}, ay[2] = {1.f - t.yd, t.yd},
              az[2] = {1.f - t.zd, t.zd};
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int a = c & 1, b = (c >> 1) & 1, d = c >> 2;
    const float term = kMode == kLoads
                           ? trilerp_tap(live, ry, rz, xs[a], ys[b], zs[d])
                           : ax[a] * ay[b] * az[d];
    s = c == 0 ? term : s + term;
  }
  out[i] = s;
}

template <int kMode>
cudaError_t launch(int threads, const float* live, const float* wx,
                   const float* wy, const float* wz, long long n, int rx,
                   int ry, int rz, float* out, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + threads - 1) / threads);
  switch (threads) {
    case 128:
      trilerp_ablation_kernel<kMode, 128>
          <<<grid, 128, 0, stream>>>(live, wx, wy, wz, n, rx, ry, rz, out);
      break;
    case 256:
      trilerp_ablation_kernel<kMode, 256>
          <<<grid, 256, 0, stream>>>(live, wx, wy, wz, n, rx, ry, rz, out);
      break;
    case 512:
      trilerp_ablation_kernel<kMode, 512>
          <<<grid, 512, 0, stream>>>(live, wx, wy, wz, n, rx, ry, rz, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// mode: 0 loads, 1 weights, 2 full; threads: 128, 256 or 512 per block.
extern "C" int dfb_trilerp_ablation(int mode, int threads, const float* live,
                                    const float* wx, const float* wy,
                                    const float* wz, long long n, int rx,
                                    int ry, int rz, float* out,
                                    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kLoads:
      return (int)launch<kLoads>(threads, live, wx, wy, wz, n, rx, ry, rz,
                                 out, s);
    case kWeights:
      return (int)launch<kWeights>(threads, live, wx, wy, wz, n, rx, ry, rz,
                                   out, s);
    case kFull:
      return (int)launch<kFull>(threads, live, wx, wy, wz, n, rx, ry, rz,
                                out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
