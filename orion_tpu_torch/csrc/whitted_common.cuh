// The Whitted lane of the Whitted megakernels (whitted.cu over a swept
// table, bvh_whitted.cu over a tree), templated over the geometry as the
// path lane of fused_common.cuh is.
//
// The estimator of the reference's point-light branch (raytracer.cpp:195-207,
// material.hpp:72-93), as the TPU kernels compute it
// (orion_tpu/ops/pallas_whitted.py, pallas_bvh_whitted.py):
//   - PCG4D-jittered primary rays (the path kernels' draw, fused_common.cuh);
//   - the nearest hit over the [rows, 40] table (the path table's 32
//     columns plus Ka, Ks and shininess);
//   - the depth-0 emissive term Ke * meshArea * cos, only when the scene has
//     an emitter;
//   - per point light (<= 8, read from a small device array, not compiled
//     in) an any-hit shadow query: ANY intersection at any t >= 0 blocks,
//     even geometry past the light (the reference's quirk), so it leaves at
//     its first hit;
//   - Phong: color * (Ka + max(n.l, 0) Kd + 0.5 pow(max(v.r, 0), Ns) Ks)
//     * I / d^2, pow taken as expf(Ns * logf(x)) with C's pow(0, 0) = 1 and
//     pow(0, Ns > 0) = 0;
//   - the mirror continuation with throughput T * Ks; a ray whose
//     throughput reaches zero in every channel retires (value-identical to
//     tracing it on), and a retired lane regenerates as its next sample.
//
// The lane is templated, besides the geometry, on the table's row stride
// (40, or 48 for the textured table of bvh_whitted.cu) and on a texel hook
// that may replace the hit's Kd and Ks by its material's map entries at the
// hit's uv; the defaults (40, `NoTexel`) are the untextured kernels'
// (4 and 7a), whose machine code the hook leaves alone.
//
// One lane loop runs the estimator, `whitted_lanes`, persistent lanes
// (kernels 4, 7a and 7b): a thread renders one pixel's samples in sample
// order, writes the pixel
// and takes the next one from a global counter (render_lane.cuh's
// `take_lane`), and leaves the loop only at its test, as the path kernels'
// `render_lanes`. A pixel's radiance is the same whichever thread renders
// it, so the image is a pure function of the seed and a tile renders the
// whole image's pixels. Its counter hooks (-DORION_PATH_COUNTERS,
// render_lane.cuh) count the loop's iterations and active lanes, the
// cycles in the nearest query and in the lights' shadow queries and terms
// (the `nee` counters), and the warps' and blocks' tails.

#pragma once

#include "render_lane.cuh"

namespace orion {

constexpr int kWCols = 40;          // Whitted table row width
constexpr int C_KA = 32, C_KS = 35, C_SHIN = 38;
constexpr int kLightCols = 8;       // position(3) color(3) intensity, 0

template <class G>
struct WhittedParamsT {
  const float* cam;      // [12] origin | front | right | up
  G geo;                 // Geo: [T_pad, 40] table; Tree: nodes + table
  const float* lights;   // [n_lights, 8]
  float* out;            // [n_lanes, 3] radiance / spp
  int n_lights, W, H, samples, max_depth, with_emissive;
  uint32_t seed;
  int pix_base = 0;      // global pixel of out's first row (a tile's offset)
};

// powf's special cases on a non-negative base: pow(0, 0) = 1, pow(0, e) = 0
__device__ __forceinline__ float pow_like_c(float x, float e) {
  if (x > 0.0f) return expf(e * logf(x));
  return e == 0.0f ? 1.0f : 0.0f;
}

// the winner's shading frame at the ray's hit: hit point, unit shading
// normal (interpolated at the winner's u, v) and geometric normal (the Woop
// w-row rescaled by |n|)
__device__ __forceinline__ void hit_frame(const float* g, const Ray& r,
                                          float t, float& hx, float& hy,
                                          float& hz, float& snx, float& sny,
                                          float& snz, float& gnx, float& gny,
                                          float& gnz, float& u, float& v) {
  woop<true>(g, r, &u, &v);
  hx = r.ox + t * r.dx; hy = r.oy + t * r.dy; hz = r.oz + t * r.dz;
  const float wb = 1.0f - u - v;
  snx = wb * __ldg(g + C_N0) + u * __ldg(g + C_N1) + v * __ldg(g + C_N2);
  sny = wb * __ldg(g + C_N0 + 1) + u * __ldg(g + C_N1 + 1) +
        v * __ldg(g + C_N2 + 1);
  snz = wb * __ldg(g + C_N0 + 2) + u * __ldg(g + C_N1 + 2) +
        v * __ldg(g + C_N2 + 2);
  norm3(snx, sny, snz);
  const float s = sqrtf(__ldg(g + 12));
  gnx = __ldg(g + 6) * s; gny = __ldg(g + 7) * s; gnz = __ldg(g + 8) * s;
}

// the untextured kernels' texel hook: the table's solid Kd and Ks stay
struct NoTexel {
  __device__ __forceinline__ void operator()(const float*, float, float,
                                             float*, float*) const {}
};

// Persistent lanes: run pixels p.pix_base + [0, n_lanes), each taken from
// *next (zero at launch). `tex(g, u, v, kd, ks)` sees the winner's table
// row and its barycentrics once Kd and Ks are read from the row.
//
// One iteration is one vertex of a Whitted sample: the nearest hit of r
// and, at a hit, its emission (depth 0) and every light's Phong term,
// added to acc at the throughput T; then the mirror continuation scaled by
// Ks (r, T and depth move to the mirror's ray), or, where the ray does not
// go on, the end of the sample. The vertex is written out in the loop, as
// it was when two loops expanded it as one macro: 7a and 7b compile to the
// same machine code (tools/sass_diff.py).
template <class G, int kStride, class Tex>
__device__ __forceinline__ void whitted_lanes(const WhittedParamsT<G>& p,
                                              const float* sgeo, int n_lanes,
                                              int* next,
                                              const Tex& tex ORION_PC_ARG) {
  int lane = take_lane(next);
  if (lane >= n_lanes) return;
  // the camera is read where a sample starts, not held in 12 registers
  const float* cam = p.cam;
  const float inv_s = static_cast<float>(1.0 / p.samples);

  int pix = p.pix_base + lane;
  Ray r;
  int samp = 0, depth = 0;
  primary(cam, p.seed, p.W, p.H, pix, 0, r);
  float T[3] = {1.f, 1.f, 1.f};
  float acc[3] = {0.f, 0.f, 0.f};

  // no `break`: a lane leaves only at the loop's test, so the lanes that
  // stay rejoin there and start every vertex together
  while (lane < n_lanes) {
    ORION_PC(pc_warp_vote(pc.iters, pc.iter_lanes);)
    ORION_PC(const long long pc0 = clock64();)
    float t;
    const int row = nearest<kStride>(p.geo, sgeo, r, kBig, t);
    ORION_PC(pc.nearest += clock64() - pc0;)
    const bool hit = row >= 0;
    float ks[3] = {0.f, 0.f, 0.f};
    float hx = 0.f, hy = 0.f, hz = 0.f, snx = 0.f, sny = 0.f, snz = 0.f;
    if (hit) {
      const float* g = p.geo.tab + row * kStride;
      float u, v, gnx, gny, gnz;
      hit_frame(g, r, t, hx, hy, hz, snx, sny, snz, gnx, gny, gnz, u, v);
      float kd[3], ka[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        kd[ch] = __ldg(g + C_KD + ch);
        ka[ch] = __ldg(g + C_KA + ch);
        ks[ch] = __ldg(g + C_KS + ch);
      }
      tex(g, u, v, kd, ks);
      const float shin = __ldg(g + C_SHIN);

      float r3[3] = {0.f, 0.f, 0.f};
      if (p.with_emissive) {
        float ndx = r.dx, ndy = r.dy, ndz = r.dz;
        norm3(ndx, ndy, ndz);
        const float cosv = -(ndx * snx + ndy * sny + ndz * snz);
        const float em_scale = depth == 0 ? __ldg(g + C_AREA) * cosv : 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          r3[ch] += __ldg(g + C_KE + ch) * em_scale;
      }

      float vdx = -r.dx, vdy = -r.dy, vdz = -r.dz;
      norm3(vdx, vdy, vdz);
      Ray sr;
      sr.ox = hx + kBias * gnx;
      sr.oy = hy + kBias * gny;
      sr.oz = hz + kBias * gnz;
      ORION_PC(pc_warp_vote(pc.nee_iters, pc.nee_lanes);
               const long long pc1 = clock64();)
      for (int li = 0; li < p.n_lights; ++li) {
        const float* Lr = p.lights + li * kLightCols;
        const float tlx = __ldg(Lr + 0) - hx, tly = __ldg(Lr + 1) - hy,
                    tlz = __ldg(Lr + 2) - hz;
        sr.dx = tlx; sr.dy = tly; sr.dz = tlz;
        if (any_hit<kStride>(p.geo, sgeo, sr)) continue;  // scale 0
        const float d2 = tlx * tlx + tly * tly + tlz * tlz;
        float ldx = tlx, ldy = tly, ldz = tlz;
        norm3(ldx, ldy, ldz);
        const float ndotl = fmaxf(snx * ldx + sny * ldy + snz * ldz, 0.0f);
        // reflect(-light_dir, n), then its cosine against the view dir
        const float dot_ln = -(ldx * snx + ldy * sny + ldz * snz);
        const float rx = -ldx - 2.0f * dot_ln * snx;
        const float ry = -ldy - 2.0f * dot_ln * sny;
        const float rz = -ldz - 2.0f * dot_ln * snz;
        const float spec_cos = fmaxf(vdx * rx + vdy * ry + vdz * rz, 0.0f);
        const float spec = 0.5f * pow_like_c(spec_cos, shin);
        const float scale = __ldg(Lr + 6) / fmaxf(d2, 1e-20f);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          r3[ch] += __ldg(Lr + 3 + ch) * (ka[ch] + ndotl * kd[ch] +
                                          spec * ks[ch]) * scale;
      }
      ORION_PC(pc.nee += clock64() - pc1;)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) acc[ch] += T[ch] * r3[ch];
    }

    // mirror continuation scaled by Ks; zero-throughput rays retire
    const float n0 = T[0] * ks[0], n1 = T[1] * ks[1], n2 = T[2] * ks[2];
    const bool nonzero = (n0 > 0.0f) || (n1 > 0.0f) || (n2 > 0.0f);
    if (hit && depth < p.max_depth && nonzero) {
      const float dot_dn = r.dx * snx + r.dy * sny + r.dz * snz;
      r.dx = r.dx - 2.0f * dot_dn * snx;
      r.dy = r.dy - 2.0f * dot_dn * sny;
      r.dz = r.dz - 2.0f * dot_dn * snz;
      r.ox = hx + snx * kBias;
      r.oy = hy + sny * kBias;
      r.oz = hz + snz * kBias;
      T[0] = n0; T[1] = n1; T[2] = n2;
      ++depth;
    } else {
      // the sample ends: it regenerates as the pixel's next sample, or
      // writes the pixel and takes the next one
      ++samp;
      depth = 0;
      T[0] = T[1] = T[2] = 1.0f;
      if (samp == p.samples) {
        float* out = p.out + 3 * lane;
        out[0] = acc[0] * inv_s;
        out[1] = acc[1] * inv_s;
        out[2] = acc[2] * inv_s;
        acc[0] = acc[1] = acc[2] = 0.f;
        samp = 0;
        lane = take_lane(next);
        pix = p.pix_base + lane;
      }
      if (lane < n_lanes) primary(cam, p.seed, p.W, p.H, pix, samp, r);
    }
  }
  ORION_PC(pc.t_done = clock64();)
}

}  // namespace orion
