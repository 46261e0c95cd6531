// The Whitted megakernel: one thread per pixel lane, point lights.
//
// Replaces: orion_tpu/ops/pallas_whitted.py::_make_whitted_kernel (launched
// by make_fused_whitted_renderer).
//
// The lane is whitted_common.cuh's `whitted_lane` over a `Geo`: the nearest
// sweep over the [T_pad, 40] table, chunk-culled past one chunk, and one
// any-hit shadow sweep per point light that leaves at its first hit.
//
// What bounds it on the H100: operations. Every bounce sweeps the table
// (39 FP32 operations per Woop test) for the nearest hit and once per light
// up to the first hit; the bytes are the table (L1/L2 resident, staged in
// shared memory when it fits one chunk), 12 bytes of image per pixel and a
// few constants. Design: the whole path state in registers, lanes leave the
// loop on their own (no lockstep tail); the sweeps are fused_common.cuh's.

#include "whitted_common.cuh"

namespace {

using namespace orion;

using WhittedParams = WhittedParamsT<Geo>;

__global__ void __launch_bounds__(kThreads)
whitted_kernel(const WhittedParams p) {
  extern __shared__ float sgeo[];  // resident tables only: [T_pad, 16]
  stage_geo<kWCols>(p.geo, sgeo);
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= p.W * p.H) return;
  whitted_lane(p, sgeo, pix);
}

}  // namespace

extern "C" int whitted_launch(const float* cam, const float* tab,
                              const float* clo, const float* chi,
                              const float* lights, float* out, int T_pad,
                              int n_chunks, int n_lights, int W, int H,
                              int samples, int max_depth, int with_emissive,
                              int seed, void* stream) {
  const WhittedParams p{cam, Geo{tab, clo, chi, T_pad, n_chunks}, lights,
                        out, n_lights, W, H, samples, max_depth,
                        with_emissive, static_cast<uint32_t>(seed)};
  const int n_pix = W * H;
  const size_t smem = p.geo.resident() ? sizeof(float) * T_pad * kGeo : 0;
  if (n_pix > 0) {
    whitted_kernel<<<(n_pix + kThreads - 1) / kThreads, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
