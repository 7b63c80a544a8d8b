// K8: the rigid TSDF-to-TSDF update, one pass over the canonical volume.
//
// Replaces no TPU kernel: the JAX package runs the plain jnp
// models/tsdf_volume.py:update_tsdf_rigid (the reference FusionDM.updateTSDF,
// core/fusion_dm.py:300-316). Per voxel (x + x_offset, y, z) of the canonical
// (values, weights): the centre moved by the pose DQ through the sandwich
// dq . v . conj(dq) (trilerp.cuh:dq_point), the live TSDF sampled there
// (in_volume, trilerp_c32: ops/interp.py:trilinear_c's order), and, where
// the sample lies in the live volume and above -tdist, the running average
// with weight 1 and the WMAX clamp. The sandwich is kept as it is and not
// folded into an affine M.p + t: the plain twin
// (ops/rigid_update_cuda.py:rigid_update_ref) and the benchmark's reference
// round in the sandwich's order, and a sample that rounds otherwise can
// cross the -tdist test. With -fmad=false and IEEE division the kernel
// rounds as the twin does.
//
// Bound on this card: memory. Each voxel reads its value and weight and
// writes them (16 bytes) and reads the live volume once (4 bytes): 20 bytes
// a voxel, 2.68 GB at 512^3, 0.80 ms at 3.35 TB/s. The arithmetic, ~120
// float32 operations a voxel, would take 0.24 ms at 67 TFLOP/s. Design: a
// block per (x, y) row of the volume, its threads along z, the contiguous
// axis, so values and weights stream coalesced; with 16-byte accesses where
// Z is a multiple of 4 and values and weights start on 16 bytes (kVec 4:
// each thread four neighbours in z; 1.02 against 1.14 ms for the scalar
// instantiation at 512^3 on the H100). The pose is near identity, so a row's taps
// lie in 2 x 2 rows of live that the neighbouring rows, run by the blocks
// around it at the same time, tap too: live comes from HBM about once and
// from L1/L2 after. Values and weights are read and written with the
// streaming (evict-first) hints, so the L2 keeps live. The DQ is read from
// the card (8 floats): no upload. The sandwich's products that do not
// depend on z are the same along a row; the compiler computes them once a
// thread (they are invariant in its loop and shared by its four voxels),
// which changes no rounding.

#include "trilerp.cuh"

namespace {

constexpr int kThreads = 128;

// The update of one voxel's (v, w) at the canonical centre (fx, fy, fz).
__device__ __forceinline__ void update_voxel(const float* q, float fx,
                                             float fy, float fz,
                                             const float* __restrict__ live,
                                             int rx, int ry, int rz,
                                             float tdist, float wmax,
                                             float& v, float& w) {
  float px = fx, py = fy, pz = fz;
  dq_point(q, px, py, pz);
  if (!in_volume(px, py, pz, rx, ry, rz)) return;
  const float s = trilerp_c32(live, rx, ry, rz, px, py, pz);
  if (!(s > -tdist)) return;
  const float nw = w + 1.f;
  v = (v * w + fminf(s, tdist) * 1.f) / nw;
  w = fminf(nw, wmax);
}

// Block = one (x, y) row; kVec = 4: float4 accesses, 4 voxels a thread.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    rigid_update_kernel(const float* __restrict__ vals,
                        const float* __restrict__ wts,
                        const float* __restrict__ live,
                        const float* __restrict__ dq, int Y, int Z, int rx,
                        int ry, int rz, int x_offset, float tdist,
                        float wmax, float* __restrict__ out_v,
                        float* __restrict__ out_w) {
  const int row = blockIdx.x;
  const int x = row / Y;
  const float fx = (float)(x + x_offset), fy = (float)(row - x * Y);
  float q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) q[e] = __ldg(dq + e);
  const int base = row * Z;  // < 2^31: the wrapper refuses larger volumes
  for (int z = threadIdx.x * kVec; z < Z; z += kThreads * kVec) {
    const int i = base + z;
    if constexpr (kVec == 4) {
      float4 v = __ldcs(reinterpret_cast<const float4*>(vals + i));
      float4 w = __ldcs(reinterpret_cast<const float4*>(wts + i));
      update_voxel(q, fx, fy, (float)z, live, rx, ry, rz, tdist, wmax, v.x,
                   w.x);
      update_voxel(q, fx, fy, (float)(z + 1), live, rx, ry, rz, tdist, wmax,
                   v.y, w.y);
      update_voxel(q, fx, fy, (float)(z + 2), live, rx, ry, rz, tdist, wmax,
                   v.z, w.z);
      update_voxel(q, fx, fy, (float)(z + 3), live, rx, ry, rz, tdist, wmax,
                   v.w, w.w);
      __stcs(reinterpret_cast<float4*>(out_v + i), v);
      __stcs(reinterpret_cast<float4*>(out_w + i), w);
    } else {
      float v = __ldcs(vals + i), w = __ldcs(wts + i);
      update_voxel(q, fx, fy, (float)z, live, rx, ry, rz, tdist, wmax, v, w);
      __stcs(out_v + i, v);
      __stcs(out_w + i, w);
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, int, int, int, int, int, int, float,
                        float, float*, float*);

Kernel kernel_at(int vec) {
  if (vec == 4) return rigid_update_kernel<4>;
  if (vec == 1) return rigid_update_kernel<1>;
  return nullptr;
}

}  // namespace

extern "C" int dfb_rigid_update(const float* vals, const float* wts,
                                const float* live, const float* dq, int X,
                                int Y, int Z, int rx, int ry, int rz,
                                int x_offset, float tdist, float wmax,
                                float* out_v, float* out_w, int vec,
                                void* stream) {
  const Kernel kernel = kernel_at(vec);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)X * Y;
  if (rows > 0 && Z > 0)
    kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
        vals, wts, live, dq, Y, Z, rx, ry, rz, x_offset, tdist, wmax, out_v,
        out_w);
  return (int)cudaGetLastError();
}

// out: registers, local (spill) bytes per thread, threads per CTA, CTAs per
// SM, static shared bytes, 0
extern "C" int dfb_rigid_update_info(int vec, int* out) {
  const Kernel kernel = kernel_at(vec);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
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
