// The Whitted megakernels over a BVH: the whole Whitted render of a scene
// past the brute sweep's gate in one launch, untextured (7a) or as the
// texture-independent records of a textured scene (7b).
//
// Replaces: orion_tpu/ops/pallas_bvh_whitted.py::_make_kernel (7a, launched
// by make_bvh_whitted_renderer) and ::_make_deferred_kernel (7b, launched
// by make_bvh_whitted_deferred).
//
// bvh_whitted_kernel (7a): whitted_common.cuh's `whitted_lane` over a
// `Tree`: the nearest hit and every light's any-hit shadow query are
// fused_common.cuh's skip-pointer walks over a bundled [B_pad, 40] table
// (the Whitted row: path columns, Ka, Ks, shininess). Output [n_lanes, 3]
// = radiance / spp of the lanes [pix_base, pix_base + n_lanes): a tile
// renders the same pixels as the whole image.
//
// bvh_whitted_deferred_kernel (7b): textured Whitted scenes. A texel is
// unknown inside the kernel, so per (sample, bounce, lane) it writes the
// record of the bounce's texture-independent factors (the TPU kernel's
// `rec`, pallas_bvh_whitted.py:780-789):
//   0-1  interpolated uv,  2  material id,
//   3-5  sum_l c_l Ka s_l (+ the depth-0 emission Ke * area * cos),
//   6-8  Cd = sum_l c_l max(n.l, 0) s_l,  9-11  Cs = sum_l c_l 0.5 spec^Ns s_l,
// with s_l = vis_l I_l / d_l^2, all zero where the bounce misses. The
// samples run in lockstep, [samp_base, samp_base + chunk), each keyed on
// its global index so chunked launches compose; every sample runs
// max_depth + 1 bounces, and the mirror chain goes on wherever a bounce
// hits (no zero-throughput pruning: ks(uv) is unknown here). The texel
// resolve and the back-to-front fold contrib = r + Cd kd + ks (Cs +
// contrib) run after the kernel (ops/bvh_whitted.py). Records are planes
// [chunk * (max_depth + 1) * 12, n_lanes]: a warp's 32 lanes write 128
// contiguous bytes per field (the TPU layout's 4 padding rows are a
// sublane device and are not written).
//
// The TPU kernels walk one pointer per block of 256 lanes and pick the
// winner's attributes out of the leaf with a one-hot MXU product; a thread
// here walks alone and reads the winner's row once after the walk, with
// the (u, v) of the same Woop test that chose it.
//
// What bounds them on the H100: operations and latency, as kernel 8
// (bvh_path.cu): a slab test is 12 FP32 operations on a 32-byte node row,
// a Woop test 39 on a table row; nodes and table stay in L2 (a 35k-triangle
// scene at leaf width 2: about 0.9 MB of nodes, 5.8 MB of 160-byte rows).
// 7a writes 12 bytes per pixel. 7b writes 48 bytes per (sample, bounce,
// pixel): 2.0 GB at 1920x1080, 4 spp, depth 4, 0.6 ms at 3.35 TB/s, below
// its walks' time.

#include "whitted_common.cuh"

namespace {

using namespace orion;

constexpr int kDCols = 48;              // deferred table row width
constexpr int C_UVX = 40, C_UVY = 43;   // corner uvs, corner-major per axis
constexpr int kRec = 12;                // record floats per bounce

using TreeWhitted = WhittedParamsT<Tree>;

__global__ void __launch_bounds__(kThreads)
bvh_whitted_kernel(const TreeWhitted p, int n_lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int pix = p.pix_base + lane;
  if (lane >= n_lanes || pix >= p.W * p.H) return;
  whitted_lane(p, nullptr, pix);
}

struct DeferredParams {
  const float* cam;      // [12]
  Tree geo;              // nodes + [B_pad, 48] table
  const float* lights;   // [n_lights, 8]
  float* rec;            // [chunk * (max_depth + 1) * 12, n_lanes]
  int n_lights, W, H, chunk, samp_base, max_depth, with_emissive;
  uint32_t seed;
  int pix_base, n_lanes;
};

__global__ void __launch_bounds__(kThreads)
bvh_whitted_deferred_kernel(const DeferredParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int pix = p.pix_base + lane;
  if (lane >= p.n_lanes || pix >= p.W * p.H) return;
  float cam[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) cam[k] = __ldg(p.cam + k);
  const int D1 = p.max_depth + 1;

  for (int s = 0; s < p.chunk; ++s) {
    Ray r;
    primary(cam, p.seed, p.W, p.H, pix, p.samp_base + s, r);
    bool alive = true;
    for (int d = 0; d < D1; ++d) {
      float rec[kRec];
#pragma unroll
      for (int k = 0; k < kRec; ++k) rec[k] = 0.0f;
      float t;
      const int row =
          alive ? nearest<kDCols>(p.geo, nullptr, r, kBig, t) : -1;
      const bool hit = row >= 0;
      float hx = 0.f, hy = 0.f, hz = 0.f, snx = 0.f, sny = 0.f, snz = 0.f;
      if (hit) {
        const float* g = p.geo.tab + row * kDCols;
        float u, v, gnx, gny, gnz;
        hit_frame(g, r, t, hx, hy, hz, snx, sny, snz, gnx, gny, gnz, u, v);
        const float wb = 1.0f - u - v;
        rec[0] = wb * __ldg(g + C_UVX) + u * __ldg(g + C_UVX + 1) +
                 v * __ldg(g + C_UVX + 2);
        rec[1] = wb * __ldg(g + C_UVY) + u * __ldg(g + C_UVY + 1) +
                 v * __ldg(g + C_UVY + 2);
        rec[2] = __ldg(g + C_MESH);
        const float ka[3] = {__ldg(g + C_KA), __ldg(g + C_KA + 1),
                             __ldg(g + C_KA + 2)};
        const float shin = __ldg(g + C_SHIN);
        if (p.with_emissive && d == 0) {
          float ndx = r.dx, ndy = r.dy, ndz = r.dz;
          norm3(ndx, ndy, ndz);
          const float cosv = -(ndx * snx + ndy * sny + ndz * snz);
          const float em_scale = __ldg(g + C_AREA) * cosv;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            rec[3 + ch] += __ldg(g + C_KE + ch) * em_scale;
        }
        float vdx = -r.dx, vdy = -r.dy, vdz = -r.dz;
        norm3(vdx, vdy, vdz);
        Ray sr;
        sr.ox = hx + kBias * gnx;
        sr.oy = hy + kBias * gny;
        sr.oz = hz + kBias * gnz;
        for (int li = 0; li < p.n_lights; ++li) {
          const float* Lr = p.lights + li * kLightCols;
          const float tlx = __ldg(Lr + 0) - hx, tly = __ldg(Lr + 1) - hy,
                      tlz = __ldg(Lr + 2) - hz;
          sr.dx = tlx; sr.dy = tly; sr.dz = tlz;
          if (any_hit<kDCols>(p.geo, nullptr, sr)) continue;  // scale 0
          const float d2 = tlx * tlx + tly * tly + tlz * tlz;
          float ldx = tlx, ldy = tly, ldz = tlz;
          norm3(ldx, ldy, ldz);
          const float ndotl = fmaxf(snx * ldx + sny * ldy + snz * ldz, 0.0f);
          const float dot_ln = -(ldx * snx + ldy * sny + ldz * snz);
          const float rx = -ldx - 2.0f * dot_ln * snx;
          const float ry = -ldy - 2.0f * dot_ln * sny;
          const float rz = -ldz - 2.0f * dot_ln * snz;
          const float spec_cos = fmaxf(vdx * rx + vdy * ry + vdz * rz, 0.0f);
          const float spec = 0.5f * pow_like_c(spec_cos, shin);
          const float scale = __ldg(Lr + 6) / fmaxf(d2, 1e-20f);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float lc = __ldg(Lr + 3 + ch);
            rec[3 + ch] += lc * ka[ch] * scale;
            rec[6 + ch] += lc * ndotl * scale;
            rec[9 + ch] += lc * spec * scale;
          }
        }
      }
      float* out = p.rec + static_cast<size_t>((s * D1 + d) * kRec) *
                               p.n_lanes + lane;
#pragma unroll
      for (int k = 0; k < kRec; ++k)
        out[static_cast<size_t>(k) * p.n_lanes] = rec[k];

      // mirror continuation; ks(uv) is applied after the kernel
      alive = hit && d < p.max_depth;
      if (alive) {
        const float dot_dn = r.dx * snx + r.dy * sny + r.dz * snz;
        r.dx = r.dx - 2.0f * dot_dn * snx;
        r.dy = r.dy - 2.0f * dot_dn * sny;
        r.dz = r.dz - 2.0f * dot_dn * snz;
        r.ox = hx + snx * kBias;
        r.oy = hy + sny * kBias;
        r.oz = hz + snz * kBias;
      }
    }
  }
}

}  // namespace

extern "C" int bvh_whitted_launch(const float* cam, const float* nodes,
                                  const float* tab, const float* lights,
                                  float* out, int M, int leaf_width,
                                  int copies, int n_lights, int W, int H,
                                  int samples, int max_depth,
                                  int with_emissive, int seed, int pix_base,
                                  int n_lanes, void* stream) {
  TreeWhitted p{cam,
                Tree{reinterpret_cast<const float4*>(nodes), tab, M,
                     leaf_width, copies},
                lights, out, n_lights, W, H, samples, max_depth,
                with_emissive, static_cast<uint32_t>(seed), pix_base};
  if (n_lanes > 0) {
    bvh_whitted_kernel<<<(n_lanes + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, n_lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_whitted_deferred_launch(
    const float* cam, const float* nodes, const float* tab,
    const float* lights, float* rec, int M, int leaf_width, int copies,
    int n_lights, int W, int H, int chunk, int samp_base, int max_depth,
    int with_emissive, int seed, int pix_base, int n_lanes, void* stream) {
  const DeferredParams p{cam,
                         Tree{reinterpret_cast<const float4*>(nodes), tab, M,
                              leaf_width, copies},
                         lights, rec, n_lights, W, H, chunk, samp_base,
                         max_depth, with_emissive,
                         static_cast<uint32_t>(seed), pix_base, n_lanes};
  if (n_lanes > 0) {
    bvh_whitted_deferred_kernel<<<(n_lanes + kThreads - 1) / kThreads,
                                  kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
