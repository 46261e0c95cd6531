// The Whitted megakernel: one thread per pixel lane, point lights.
//
// Replaces: orion_tpu/ops/pallas_whitted.py::_make_whitted_kernel (launched
// by make_fused_whitted_renderer).
//
// The estimator of the reference's point-light branch (raytracer.cpp:195-207,
// material.hpp:72-93), as the TPU kernel computes it:
//   - PCG4D-jittered primary rays (the path kernels' draw, fused_common.cuh);
//   - the nearest sweep over the [T_pad, 40] table (the path table's 32
//     columns plus Ka, Ks and shininess), chunk-culled past one chunk;
//   - the depth-0 emissive term Ke * meshArea * cos, only when the scene has
//     an emitter;
//   - per point light (<= 8, read from a small device array, not compiled
//     in) an any-hit shadow sweep: ANY intersection at any t >= 0 blocks,
//     even geometry past the light (the reference's quirk), so the sweep
//     leaves at its first hit;
//   - Phong: color * (Ka + max(n.l, 0) Kd + 0.5 pow(max(v.r, 0), Ns) Ks)
//     * I / d^2, pow taken as expf(Ns * logf(x)) with C's pow(0, 0) = 1 and
//     pow(0, Ns > 0) = 0;
//   - the mirror continuation with throughput T * Ks; a ray whose
//     throughput reaches zero in every channel retires (value-identical to
//     tracing it on), and a retired lane regenerates as its next sample.
//
// What bounds it on the H100: operations. Every bounce sweeps the table
// (39 FP32 operations per Woop test) for the nearest hit and once per light
// up to the first hit; the bytes are the table (L1/L2 resident, staged in
// shared memory when it fits one chunk), 12 bytes of image per pixel and a
// few constants. Design: the whole path state in registers, lanes leave the
// loop on their own (no lockstep tail); the sweeps are fused_common.cuh's.

#include "fused_common.cuh"

namespace {

using namespace orion;

constexpr int kWCols = 40;          // Whitted table row width
constexpr int C_KA = 32, C_KS = 35, C_SHIN = 38;
constexpr int kLightCols = 8;       // position(3) color(3) intensity, 0

struct WhittedParams {
  const float* cam;      // [12] origin | front | right | up
  Geo geo;               // [T_pad, 40] table
  const float* lights;   // [n_lights, 8]
  float* out;            // [n_pix, 3] radiance / spp
  int n_lights, W, H, samples, max_depth, with_emissive;
  uint32_t seed;
};

// powf's special cases on a non-negative base: pow(0, 0) = 1, pow(0, e) = 0
__device__ __forceinline__ float pow_like_c(float x, float e) {
  if (x > 0.0f) return expf(e * logf(x));
  return e == 0.0f ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
whitted_kernel(const WhittedParams p) {
  extern __shared__ float sgeo[];  // resident tables only: [T_pad, 16]
  stage_geo<kWCols>(p.geo, sgeo);
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= p.W * p.H) return;

  float cam[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) cam[k] = __ldg(p.cam + k);

  Ray r;
  int samp = 0, depth = 0;
  primary(cam, p.seed, p.W, p.H, pix, 0, r);
  float T[3] = {1.f, 1.f, 1.f};
  float acc[3] = {0.f, 0.f, 0.f};

  while (samp < p.samples) {
    float t;
    const int row = nearest<kWCols>(p.geo, sgeo, r, kBig, t);
    const bool hit = row >= 0;
    float ks[3] = {0.f, 0.f, 0.f};
    float hx = 0.f, hy = 0.f, hz = 0.f, snx = 0.f, sny = 0.f, snz = 0.f;
    if (hit) {
      const float* g = p.geo.tab + row * kWCols;
      float u, v;
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
      const float gnx = __ldg(g + 6) * s, gny = __ldg(g + 7) * s,
                  gnz = __ldg(g + 8) * s;
      float kd[3], ka[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        kd[ch] = __ldg(g + C_KD + ch);
        ka[ch] = __ldg(g + C_KA + ch);
        ks[ch] = __ldg(g + C_KS + ch);
      }
      const float shin = __ldg(g + C_SHIN);

      float r3[3] = {0.f, 0.f, 0.f};
      if (p.with_emissive) {
        float ndx = r.dx, ndy = r.dy, ndz = r.dz;
        norm3(ndx, ndy, ndz);
        const float cosv = -(ndx * snx + ndy * sny + ndz * snz);
        const float em_scale = depth == 0 ? __ldg(g + C_AREA) * cosv : 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) r3[ch] += __ldg(g + C_KE + ch) * em_scale;
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
        if (any_hit<kWCols>(p.geo, sgeo, sr)) continue;  // scale 0
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
      ++samp;
      depth = 0;
      T[0] = T[1] = T[2] = 1.0f;
      if (samp < p.samples) primary(cam, p.seed, p.W, p.H, pix, samp, r);
    }
  }
  const float inv_s = static_cast<float>(1.0 / p.samples);
  p.out[3 * pix + 0] = acc[0] * inv_s;
  p.out[3 * pix + 1] = acc[1] * inv_s;
  p.out[3 * pix + 2] = acc[2] * inv_s;
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
