// Regenerative path-tracing megakernel: the whole path tracer in one launch.
//
// Replaces: orion_tpu/ops/pallas_fused.py::_make_kernel (launched by
// build_fused_call), the estimator of _make_regen_body with fast_shadow=True.
//
// Per pixel lane, until the lane's sample index reaches `samples`:
// PCG4D-jittered primary ray (one jitter per sample, shared by all pixels);
// Woop nearest-hit sweep over the [T_pad, 32] table (min t, ties -> min row);
// depth-0 emission Ke * meshArea * cos; next-event estimation over every
// emissive mesh (<= 8 meshes of <= 8 triangles), `light_samples` draws each,
// visible iff the nearest hit with t < NEE_T_CAP lies on the sampled mesh;
// Russian roulette on max(kd); cosine-weighted bounce; on termination the
// lane regenerates as its next sample. Output: [n_pix, 3] = radiance / spp.
//
// What bounds it on the H100: operations. Every sweep tests each ray
// against every table row, chunk-culled for big tables, and every path
// vertex runs 1 + n_emitters * light_samples sweeps. A test is 39 FP32
// operations (chip_smoke.py's WOOP_TEST_FLOPS): origin transform
// 3 x (3 mul + 3 add), direction transform 3 x (3 mul + 2 add), one divide,
// u/v 2 x (mul + add), the eps product. The bytes are the 128-byte table rows, which stay in L1/L2 (the
// Cornell table is 5 KB, the 16,384-row cap 2 MB), and 12 bytes of output
// per pixel. The other cost is divergence: lanes of a warp sit at different
// depths and samples, so a warp runs as long as its longest lane.
//
// Design: one thread per pixel lane with its whole path state in registers;
// a `while` over (sample, depth) as on the TPU, but each lane leaves the loop
// on its own (no block-wide quiescence test). Tables up to one chunk (512
// rows) are staged once per block into shared memory (13 Woop floats per
// row at a 16-float stride, 32 KB at most) and read by broadcast; larger
// tables are read through the read-only cache in 512-row chunks, each
// chunk's AABB slab-tested per lane against the lane's live segment
// [0, t_best) and skipped when the lane cannot improve (value-identical up
// to rounding at the box boundary; the TPU kernel votes per block). Winner
// attributes are read from the winner's table row only, instead of the TPU
// kernel's select-reduce or one-hot MXU gather.
//
// Random numbers are the TPU kernel's: stateless PCG4D hashes of (pixel,
// sample, depth, site) in wrapping uint32 arithmetic with logical shifts, so
// the image is a pure function of the seed.
//
// The lane loop and the sweeps live in fused_common.cuh, shared with the
// training kernels (prb.cu); this file is its fast-shadow render
// instantiation.

#include "fused_common.cuh"

namespace {

using namespace orion;

__global__ void __launch_bounds__(kThreads)
fused_path_kernel(const PathParams p) {
  extern __shared__ float sgeo[];  // resident tables only: [T_pad, 16]
  stage_geo<kCols>(p.geo, sgeo);
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= p.W * p.H) return;
  path_lane<false, kRender>(p, sgeo, pix, nullptr, nullptr);
}

}  // namespace

extern "C" int fused_path_launch(const float* cam, const float* tab,
                                 const float* clo, const float* chi,
                                 const float* em, float* out, int T_pad,
                                 int n_chunks, int n_em, int W, int H,
                                 int samples, int max_depth,
                                 int light_samples, int seed, void* stream) {
  PathParams p{cam, Geo{tab, clo, chi, T_pad, n_chunks}, em, out, nullptr,
               nullptr, n_em, W, H, samples, max_depth, light_samples,
               static_cast<uint32_t>(seed)};
  const int n_pix = W * H;
  const size_t smem = p.geo.resident() ? sizeof(float) * T_pad * kGeo : 0;
  if (n_pix > 0) {
    fused_path_kernel<<<(n_pix + kThreads - 1) / kThreads, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
