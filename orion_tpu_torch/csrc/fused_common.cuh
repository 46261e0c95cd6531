// Shared device code of the path kernels (fused_path.cu, prb.cu,
// bvh_path.cu), the Whitted kernels (whitted.cu, bvh_whitted.cu, through
// whitted_common.cuh) and the wavefront's walk kernel (bvh_intersect.cu):
// PCG4D, the Woop test, the nearest-hit and any-hit sweeps over a triangle
// table, the skip-pointer walk over a flattened tree (nearest and any hit),
// primary rays, and the regenerative path lane loop, templated over its
// geometry (`Geo`: a table swept chunk by chunk; `Tree`: a skip-pointer BVH
// over a bundled table), its NEE form and what it records.
//
// The lane loop (`path_lane`) is the estimator of
// orion_tpu/ops/pallas_fused.py::_make_regen_body, one thread per pixel
// lane, for the training kernels over a swept table (prb.cu's 3a/3b). Its
// two modes:
//   kForwardLs : legacy NEE, radiance / spp out plus each sample's radiance
//                L_s (prb.cu, the training forward);
//   kReplay    : legacy NEE, re-traces the same paths and accumulates the
//                closed-form material adjoints (prb.cu, the replay).
// The render kernels (fused_path.cu, bvh_path.cu) and the training pair
// over a tree (prb.cu's 9a/9b) run render_lane.cuh's persistent lane loop
// over the same NEE (`nee`, both forms) and `bounce_contrib`.
// The forward and the replay must compute every bounce's contribution
// bit for bit alike, or the replay's remaining radiance U = L_s - sum of
// contributions drifts. Each pair is two instantiations of one loop
// (`path_lane` here, `render_lanes` for 9a/9b), and the contribution, the running sums and U are computed with
// __fmul_rn/__fadd_rn/__fsub_rn, which the compiler never contracts into
// an FMA, so no context-dependent contraction can make them differ.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace orion {

constexpr int kThreads = 128;
constexpr int kChunk = 512;          // FUSED_CHUNK
constexpr int kCols = 32;            // path table row width
constexpr int kGeo = 16;             // staged Woop row stride
constexpr int kEmStride = 160;       // emitter record (see fused_path.py)
constexpr int kEmHeader = 8;
constexpr int kEmTri = 19;
constexpr int kMLanes = 128;         // M_LANES: replay accumulator columns
constexpr float kBig = 3.0e38f;
constexpr float kMtEps = 1e-6f;
constexpr float kBias = 1e-3f;
constexpr float kNeeTCap = 1.05f;

// table columns (pallas_fused.py _C_*)
constexpr int C_N0 = 13, C_N1 = 16, C_N2 = 19, C_KD = 22, C_KE = 25,
              C_AREA = 28, C_MESH = 29;

enum Mode { kRender = 0, kForwardLs = 1, kReplay = 2 };

// a triangle table and its chunk AABBs
struct Geo {
  const float* tab;   // [T_pad, stride]
  const float* clo;   // [n_chunks, 3]
  const float* chi;   // [n_chunks, 3]
  int T_pad, n_chunks;
  __host__ __device__ __forceinline__ bool resident() const {
    return n_chunks <= 1 && T_pad <= kChunk;
  }
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d; b += c * a; c += a * b; d += b * c;
  a ^= a >> 16; b ^= b >> 16; c ^= c >> 16; d ^= d >> 16;
  a += b * d; b += c * a; c += a * b; d += b * c;
}

__device__ __forceinline__ float u01(uint32_t x) {
  return static_cast<float>(x & 0xFFFFFFu) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
  x *= inv; y *= inv; z *= inv;
}

template <bool kGlobal>
__device__ __forceinline__ float ld(const float* p) {
  if (kGlobal) return __ldg(p);
  return *p;
}

// Woop test of one row; returns the masked t, and (u, v) on request
template <bool kGlobal>
__device__ __forceinline__ float woop(const float* w, const Ray& r,
                                      float* u_out = nullptr,
                                      float* v_out = nullptr) {
  const float w0 = ld<kGlobal>(w + 0), w1 = ld<kGlobal>(w + 1),
              w2 = ld<kGlobal>(w + 2), w3 = ld<kGlobal>(w + 3),
              w4 = ld<kGlobal>(w + 4), w5 = ld<kGlobal>(w + 5),
              w6 = ld<kGlobal>(w + 6), w7 = ld<kGlobal>(w + 7),
              w8 = ld<kGlobal>(w + 8), w9 = ld<kGlobal>(w + 9),
              w10 = ld<kGlobal>(w + 10), w11 = ld<kGlobal>(w + 11),
              w12 = ld<kGlobal>(w + 12);
  const float ou = w0 * r.ox + w1 * r.oy + w2 * r.oz + w9;
  const float ov = w3 * r.ox + w4 * r.oy + w5 * r.oz + w10;
  const float ow = w6 * r.ox + w7 * r.oy + w8 * r.oz + w11;
  const float du = w0 * r.dx + w1 * r.dy + w2 * r.dz;
  const float dv = w3 * r.dx + w4 * r.dy + w5 * r.dz;
  const float dw = w6 * r.dx + w7 * r.dy + w8 * r.dz;
  const float t = -ow / dw;
  const float u = ou + t * du;
  const float v = ov + t * dv;
  const bool ok = (fabsf(dw) * w12 > kMtEps) && (u >= 0.0f) && (u <= 1.0f) &&
                  (v >= 0.0f) && (u + v <= 1.0f) && (t >= 0.0f);
  if (u_out) {
    *u_out = ok ? u : 0.0f;
    *v_out = ok ? v : 0.0f;
  }
  return ok ? t : kBig;
}

// The same Woop test written with explicit round-to-nearest multiplies and
// adds, in ops/woop.py's op order, so that t equals the plain PyTorch
// version's bit for bit (no FMA contraction; `/` rounds to nearest): the
// wavefront walks (bvh_intersect.cu, bvh_g8.cu) and the binned round
// (binned.cu). `row` is a 16-float row (the 13 Woop floats first) as four
// float4, in global memory (kGlobal, read through the read-only cache) or
// in shared memory.
__device__ __forceinline__ float dot3_rn(float a, float b, float c, float x,
                                         float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                   __fmul_rn(c, z));
}

template <bool kGlobal>
__device__ __forceinline__ float woop_t_rn(const float4* row, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz) {
  const float4 a = kGlobal ? __ldg(row) : row[0];
  const float4 b = kGlobal ? __ldg(row + 1) : row[1];
  const float4 c = kGlobal ? __ldg(row + 2) : row[2];
  const float4 e = kGlobal ? __ldg(row + 3) : row[3];
  // a = w0..3, b = w4..7, c = w8..11, e.x = w12
  const float ou = __fadd_rn(dot3_rn(a.x, a.y, a.z, ox, oy, oz), c.y);
  const float ov = __fadd_rn(dot3_rn(a.w, b.x, b.y, ox, oy, oz), c.z);
  const float ow = __fadd_rn(dot3_rn(b.z, b.w, c.x, ox, oy, oz), c.w);
  const float du = dot3_rn(a.x, a.y, a.z, dx, dy, dz);
  const float dv = dot3_rn(a.w, b.x, b.y, dx, dy, dz);
  const float dw = dot3_rn(b.z, b.w, c.x, dx, dy, dz);
  const float t = __fdiv_rn(-ow, dw);
  const float u = __fadd_rn(ou, __fmul_rn(t, du));
  const float v = __fadd_rn(ov, __fmul_rn(t, dv));
  const bool ok = (__fmul_rn(fabsf(dw), e.x) > kMtEps) && (u >= 0.0f) &&
                  (u <= 1.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f) &&
                  (t >= 0.0f);
  return ok ? t : kBig;
}

template <bool kGlobal>
__device__ __forceinline__ void sweep_rows(const float* geo, int stride,
                                           int lo, int hi, const Ray& r,
                                           float& t_best, int& row_best) {
  for (int k = lo; k < hi; ++k) {
    const float t = woop<kGlobal>(geo + k * stride, r);
    if (t < t_best) {  // strict: the smallest row (and earliest chunk) wins
      t_best = t;
      row_best = k;
    }
  }
}

// could any row of chunk k improve on t_best? (slab test, flat boxes via >=)
__device__ __forceinline__ bool box_reachable(const Geo& g, int k,
                                              const Ray& r, float t_best) {
  const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
  const float tx0 = (__ldg(g.clo + 3 * k) - r.ox) * ix;
  const float tx1 = (__ldg(g.chi + 3 * k) - r.ox) * ix;
  const float ty0 = (__ldg(g.clo + 3 * k + 1) - r.oy) * iy;
  const float ty1 = (__ldg(g.chi + 3 * k + 1) - r.oy) * iy;
  const float tz0 = (__ldg(g.clo + 3 * k + 2) - r.oz) * iz;
  const float tz1 = (__ldg(g.chi + 3 * k + 2) - r.oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fmaxf(tz0, tz1));
  return (tmax >= tmin) && (tmax > 0.0f) && (tmin < t_best);
}

// nearest row with t < cap (ties -> min row), or -1. Resident tables are
// read from the block's shared copy `sgeo`, larger ones chunk by chunk.
template <int kStride>
__device__ __forceinline__ int nearest(const Geo& g, const float* sgeo,
                                       const Ray& r, float cap, float& t) {
  float t_best = cap;
  int row = -1;
  if (g.resident()) {
    sweep_rows<false>(sgeo, kGeo, 0, g.T_pad, r, t_best, row);
  } else {
    for (int k = 0; k < g.n_chunks; ++k) {
      if (box_reachable(g, k, r, t_best))
        sweep_rows<true>(g.tab, kStride, k * kChunk, (k + 1) * kChunk, r,
                         t_best, row);
    }
  }
  t = t_best;
  return row;
}

// does the ray hit any row at any t >= 0? Leaves at the first hit.
template <bool kGlobal>
__device__ __forceinline__ bool any_rows(const float* geo, int stride, int lo,
                                         int hi, const Ray& r) {
  for (int k = lo; k < hi; ++k)
    if (woop<kGlobal>(geo + k * stride, r) < kBig) return true;
  return false;
}

template <int kStride>
__device__ __forceinline__ bool any_hit(const Geo& g, const float* sgeo,
                                        const Ray& r) {
  if (g.resident()) return any_rows<false>(sgeo, kGeo, 0, g.T_pad, r);
  for (int k = 0; k < g.n_chunks; ++k) {
    if (box_reachable(g, k, r, kBig) &&
        any_rows<true>(g.tab, kStride, k * kChunk, (k + 1) * kChunk, r))
      return true;
  }
  return false;
}

// The skip-pointer walk over the node rows [ptr, end) of a flattened BVH
// (node i's subtree is [i + 1, skip[i]); rows are lo xyz, hi xyz, skip,
// start, the last two int32 bits; start < 0 marks an internal node). Per
// node the slab test against the ray's live segment [0, t_best) (>= so
// flat boxes hit); on a hit leaf `leaf(start, t_best, row)` tests its rows
// and lowers (t_best, row) where it finds a nearer hit; a missed box or a
// leaf jumps to skip. kAnyHit: the walk leaves after the first leaf that
// set a row. The one walk of every tree kernel: the megakernels' nearest
// and any-hit (below) and the wavefront's walk kernel (bvh_intersect.cu).
// The slab arithmetic has no multiply-add to contract and `/` rounds to
// nearest, so it gives the same bits wherever it is compiled.
template <bool kAnyHit, class Leaf>
__device__ __forceinline__ void walk_tree(const float4* nodes, int ptr,
                                          int end, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float& t_best, int& row,
                                          Leaf leaf) {
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  while (ptr < end) {
    const float4 n0 = __ldg(nodes + 2 * ptr);      // lo.xyz, hi.x
    const float4 n1 = __ldg(nodes + 2 * ptr + 1);  // hi.yz, skip, start
    const float tx0 = (n0.x - ox) * ix, tx1 = (n0.w - ox) * ix;
    const float ty0 = (n0.y - oy) * iy, ty1 = (n1.x - oy) * iy;
    const float tz0 = (n0.z - oz) * iz, tz1 = (n1.y - oz) * iz;
    const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                             fminf(tz0, tz1));
    const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                             fmaxf(tz0, tz1));
    const bool hit = (tmax >= tmin) && (tmax > 0.0f) && (tmin < t_best);
    const int start = __float_as_int(n1.w);
    if (hit && start >= 0) {
      leaf(start, t_best, row);
      if (kAnyHit && row >= 0) return;
    }
    ptr = (hit && start < 0) ? ptr + 1 : __float_as_int(n1.z);
  }
}

// a flattened skip-pointer BVH over a bundled table (bvh_path.cu,
// bvh_whitted.cu, prb.cu): `copies` concatenated flattenings of one tree,
// copy k ordered near-first for the direction octant k; a leaf owns rows
// [start & ~1, +leaf_width) of `tab` (bit 0 of a leaf start is a flag
// that these walks do not use)
struct Tree {
  const float4* nodes;  // [copies * M, 2]
  const float* tab;     // [B_pad, stride]
  int M, leaf_width, copies;
  // the node range of the copy that a ray of this direction walks
  __device__ __forceinline__ int first(const Ray& r) const {
    if (copies != 8) return 0;
    return M * ((r.dx >= 0.0f ? 1 : 0) + (r.dy >= 0.0f ? 2 : 0) +
                (r.dz >= 0.0f ? 4 : 0));
  }
};

// nearest row with t < cap over the tree, or -1: in a leaf min t with ties
// to the smallest row; across leaves only a strictly smaller t wins, in
// flattened order. `sgeo` is unused (nothing is staged for a tree).
template <int kStride>
__device__ __forceinline__ int nearest(const Tree& g, const float* sgeo,
                                       const Ray& r, float cap, float& t) {
  (void)sgeo;
  float t_best = cap;
  int row = -1;
  const int ptr = g.first(r);
  walk_tree<false>(g.nodes, ptr, ptr + g.M, r.ox, r.oy, r.oz, r.dx, r.dy,
                   r.dz, t_best, row,
                   [&](int start, float& tb, int& rb) {
                     const int lo = start & ~1;
                     sweep_rows<true>(g.tab, kStride, lo, lo + g.leaf_width,
                                      r, tb, rb);
                   });
  t = t_best;
  return row;
}

// does the ray hit any row of the tree at any t >= 0? Leaves at the first
// hit (the reference's shadow test, raytracer.cpp:196-201).
template <int kStride>
__device__ __forceinline__ bool any_hit(const Tree& g, const float* sgeo,
                                        const Ray& r) {
  (void)sgeo;
  float t_best = kBig;
  int row = -1;
  const int ptr = g.first(r);
  walk_tree<true>(g.nodes, ptr, ptr + g.M, r.ox, r.oy, r.oz, r.dx, r.dy,
                  r.dz, t_best, row,
                  [&](int start, float& tb, int& rb) {
                    const int lo = start & ~1;
                    for (int k = lo; k < lo + g.leaf_width; ++k)
                      if (woop<true>(g.tab + k * kStride, r) < kBig) {
                        rb = k;
                        return;
                      }
                  });
  return row >= 0;
}

// nothing is staged for a tree
template <int kStride>
__device__ __forceinline__ void stage_geo(const Tree&, float*) {}

// stage a resident table's 13 Woop floats per row into shared memory
template <int kStride>
__device__ __forceinline__ void stage_geo(const Geo& g, float* sgeo) {
  if (!g.resident()) return;
  for (int k = threadIdx.x; k < g.T_pad * 13; k += blockDim.x) {
    const int row = k / 13, col = k - row * 13;
    sgeo[row * kGeo + col] = __ldg(g.tab + row * kStride + col);
  }
  __syncthreads();
}

// the camera ray of `pix` for sample `samp` (one jitter per sample)
__device__ __forceinline__ void primary(const float* cam, uint32_t seed,
                                        int W, int H, int pix, int samp,
                                        Ray& r) {
  uint32_t a = static_cast<uint32_t>(samp), b = seed, c = 0x4A17u,
           d = 0x7E57u;
  pcg4d(a, b, c, d);
  const float jx = u01(a) * static_cast<float>(2.0 / W);
  const float jy = u01(b) * static_cast<float>(2.0 / H);
  const int i = pix / W;  // == floor((pix + 0.5) * (1/W)) for these sizes
  const float fi = static_cast<float>(i);
  const float fj = static_cast<float>(pix - i * W);
  const float x = 2.0f * (fj * static_cast<float>(1.0 / W)) - 1.0f + jx;
  const float y = -(2.0f * (fi * static_cast<float>(1.0 / H)) - 1.0f + jy);
  r.ox = cam[0]; r.oy = cam[1]; r.oz = cam[2];
  r.dx = cam[3] + x * cam[6] + y * cam[9];
  r.dy = cam[4] + x * cam[7] + y * cam[10];
  r.dz = cam[5] + x * cam[8] + y * cam[11];
}

// ---------------------------------------------------------------------------
// the regenerative path lane
// ---------------------------------------------------------------------------

template <class G>
struct PathParamsT {
  const float* cam;   // [12] origin | front | right | up
  G geo;              // Geo: [T_pad, 32] table; Tree: nodes + bundled table
  const float* em;    // [n_em, 160]
  float* out;         // [n_pix, 3] radiance / spp (render, forward)
  float* ls;          // [3S, n_pix] per-sample radiance (forward out,
                      // replay in)
  const float* w;     // [n_pix, 3] per-lane adjoint (replay)
  int n_em, W, H, samples, max_depth, light_samples;
  uint32_t seed;
  int pix_base = 0;   // global pixel of out's first row (a tile's offset)
};
using PathParams = PathParamsT<Geo>;

// the bounce's contribution T * (ke * em_scale + kd * A), rounded
// op by op (see the header note)
__device__ __forceinline__ void bounce_contrib(const float T[3],
                                               const float ke[3],
                                               float em_scale,
                                               const float kd[3],
                                               const float A[3],
                                               float c[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float r = __fadd_rn(__fmul_rn(ke[ch], em_scale),
                              __fmul_rn(kd[ch], A[ch]));
    c[ch] = __fmul_rn(T[ch], r);
  }
}

// Next-event estimation at hit point h. Fast form (kLegacy false): light
// normal and emitted color from the sampled emitter triangle; visible iff
// the nearest hit below kNeeTCap lies on the sampled mesh; lanes whose
// geometry term is <= 0 skip the sweep. Legacy form: the shadow sweep runs
// for every sample, and the light normal (at the winner's u, v) and the
// emitted color are the shadow winner's. Returns A (NEE radiance without
// the surface kd) and sum(scale).
template <bool kLegacy, class P>
__device__ __forceinline__ void nee(const P& p, const float* sgeo,
                                    uint32_t upix, uint32_t site_sd,
                                    float hx, float hy, float hz, float gnx,
                                    float gny, float gnz, float snx,
                                    float sny, float snz, float A[3],
                                    float& sum_scale) {
  const float inv_ls = static_cast<float>(1.0 / p.light_samples);
  Ray sray;
  sray.ox = hx + kBias * gnx;
  sray.oy = hy + kBias * gny;
  sray.oz = hz + kBias * gnz;
  for (int mi = 0; mi < p.n_em; ++mi) {
    const float* E = p.em + mi * kEmStride;
    const float mesh = __ldg(E);
    const int count = static_cast<int>(__ldg(E + 1));
    for (int ls = 0; ls < p.light_samples; ++ls) {
      const int site = ls + p.light_samples * mi;
      uint32_t a = upix, b = site_sd,
               c = 0x11u + 0x101u * static_cast<uint32_t>(site), d = p.seed;
      pcg4d(a, b, c, d);
      const float ut = u01(a), ua = u01(b), ub = u01(c);
      const int sel = min(static_cast<int>(ut * static_cast<float>(count)),
                          count - 1);
      const float* L = E + kEmHeader + kEmTri * sel;
      const bool flip = (ua + ub) > 1.0f;
      const float la = flip ? 1.0f - ua : ua;
      const float lb = flip ? 1.0f - ub : ub;
      const float sdx = __ldg(L + 0) + la * __ldg(L + 3) + lb * __ldg(L + 6) - hx;
      const float sdy = __ldg(L + 1) + la * __ldg(L + 4) + lb * __ldg(L + 7) - hy;
      const float sdz = __ldg(L + 2) + la * __ldg(L + 5) + lb * __ldg(L + 8) - hz;
      float ldx = sdx, ldy = sdy, ldz = sdz;
      norm3(ldx, ldy, ldz);
      const float cos_s = snx * ldx + sny * ldy + snz * ldz;
      sray.dx = sdx; sray.dy = sdy; sray.dz = sdz;
      float lnx, lny, lnz, ske0, ske1, ske2;
      if (kLegacy) {
        float ts;
        const int srow = nearest<kCols>(p.geo, sgeo, sray, kNeeTCap, ts);
        if (srow < 0) continue;
        const float* gs = p.geo.tab + srow * kCols;
        if (__ldg(gs + C_MESH) != mesh) continue;
        float su, sv;
        woop<true>(gs, sray, &su, &sv);
        const float sw = 1.0f - su - sv;
        lnx = sw * __ldg(gs + C_N0) + su * __ldg(gs + C_N1) + sv * __ldg(gs + C_N2);
        lny = sw * __ldg(gs + C_N0 + 1) + su * __ldg(gs + C_N1 + 1) +
              sv * __ldg(gs + C_N2 + 1);
        lnz = sw * __ldg(gs + C_N0 + 2) + su * __ldg(gs + C_N1 + 2) +
              sv * __ldg(gs + C_N2 + 2);
        norm3(lnx, lny, lnz);
        ske0 = __ldg(gs + C_KE);
        ske1 = __ldg(gs + C_KE + 1);
        ske2 = __ldg(gs + C_KE + 2);
      } else {
        const float lw = 1.0f - la - lb;
        lnx = lw * __ldg(L + 10) + la * __ldg(L + 13) + lb * __ldg(L + 16);
        lny = lw * __ldg(L + 11) + la * __ldg(L + 14) + lb * __ldg(L + 17);
        lnz = lw * __ldg(L + 12) + la * __ldg(L + 15) + lb * __ldg(L + 18);
        norm3(lnx, lny, lnz);
        ske0 = __ldg(E + 2);
        ske1 = __ldg(E + 3);
        ske2 = __ldg(E + 4);
      }
      const float cos_l = -(lnx * ldx + lny * ldy + lnz * ldz);
      const float geom = kLegacy ? fmaxf(cos_s * cos_l, 0.0f) : cos_s * cos_l;
      if (!kLegacy) {
        if (!(geom > 0.0f)) continue;  // contributes 0 whatever is visible
        float ts;
        const int srow = nearest<kCols>(p.geo, sgeo, sray, kNeeTCap, ts);
        if (srow < 0 || __ldg(p.geo.tab + srow * kCols + C_MESH) != mesh)
          continue;
      }
      const float d2 = sdx * sdx + sdy * sdy + sdz * sdz;
      const float scale = geom * __ldg(L + 9) / (1.0f + d2) * inv_ls;
      if (kLegacy) {
        A[0] = __fadd_rn(A[0], __fmul_rn(ske0, scale));
        A[1] = __fadd_rn(A[1], __fmul_rn(ske1, scale));
        A[2] = __fadd_rn(A[2], __fmul_rn(ske2, scale));
        sum_scale = __fadd_rn(sum_scale, scale);
      } else {
        A[0] += ske0 * scale;
        A[1] += ske1 * scale;
        A[2] += ske2 * scale;
      }
    }
  }
}

// One pixel lane, until its sample index reaches p.samples. kReplay reads
// the lane's L_s and adjoint, and adds its material adjoints to the block's
// shared accumulator `sacc` [6, kMLanes] (double: a grey material's
// gradient is a small difference of large per-lane terms) and its NEE
// emitted-color adjoint to `ek`.
template <bool kLegacy, int kMode, class P>
__device__ __forceinline__ void path_lane(const P& p,
                                          const float* sgeo, int pix,
                                          double* sacc, float ek[3]) {
  float cam[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) cam[k] = __ldg(p.cam + k);
  const uint32_t upix = static_cast<uint32_t>(pix);
  const int n_pix = p.W * p.H;

  Ray r;
  int samp = 0, depth = 0;
  primary(cam, p.seed, p.W, p.H, pix, 0, r);
  float T[3] = {1.f, 1.f, 1.f};
  float acc[3] = {0.f, 0.f, 0.f};   // radiance sum (forward)
  float Ls[3] = {0.f, 0.f, 0.f};    // this sample's radiance (forward)
  float U[3] = {0.f, 0.f, 0.f};     // remaining radiance (replay)
  float w[3] = {0.f, 0.f, 0.f};     // the lane's adjoint (replay)
  if (kMode == kReplay) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      U[ch] = __ldg(p.ls + ch * n_pix + pix);
      w[ch] = __ldg(p.w + 3 * pix + ch);
    }
  }

  while (samp < p.samples) {
    float t;
    const int row = nearest<kCols>(p.geo, sgeo, r, kBig, t);
    const bool hit = row >= 0;
    const uint32_t site_sd = static_cast<uint32_t>(samp) * 131071u +
                             static_cast<uint32_t>(depth);
    float kd[3] = {0.f, 0.f, 0.f};
    float hx = 0.f, hy = 0.f, hz = 0.f, snx = 0.f, sny = 0.f, snz = 0.f;
    if (hit) {
      const float* g = p.geo.tab + row * kCols;
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
      // geometric normal: the Woop w-row rescaled by |n|
      const float s = sqrtf(__ldg(g + 12));
      const float gnx = __ldg(g + 6) * s, gny = __ldg(g + 7) * s,
                  gnz = __ldg(g + 8) * s;
      kd[0] = __ldg(g + C_KD); kd[1] = __ldg(g + C_KD + 1);
      kd[2] = __ldg(g + C_KD + 2);
      const float ke[3] = {__ldg(g + C_KE), __ldg(g + C_KE + 1),
                           __ldg(g + C_KE + 2)};

      // depth-0 emissive term: Ke * meshArea * dot(norm(d), -s_n)
      float ndx = r.dx, ndy = r.dy, ndz = r.dz;
      norm3(ndx, ndy, ndz);
      const float cosv = -(ndx * snx + ndy * sny + ndz * snz);
      const float em_scale = depth == 0 ? __ldg(g + C_AREA) * cosv : 0.0f;

      float A[3] = {0.f, 0.f, 0.f};
      float sum_scale = 0.f;
      nee<kLegacy>(p, sgeo, upix, site_sd, hx, hy, hz, gnx, gny, gnz, snx,
                   sny, snz, A, sum_scale);
      {
        float c[3];
        bounce_contrib(T, ke, em_scale, kd, A, c);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          if (kMode == kForwardLs) {
            acc[ch] = __fadd_rn(acc[ch], c[ch]);
            Ls[ch] = __fadd_rn(Ls[ch], c[ch]);
          } else {
            U[ch] = __fsub_rn(U[ch], c[ch]);
          }
        }
        if (kMode == kReplay) {
          // closed-form adjoints (pallas_prb.py replay_impl :201-238);
          // p = max(kd) splits a tie evenly over the tied channels
          const float p_max = fmaxf(fmaxf(kd[0], kd[1]), kd[2]);
          const float inv_p = p_max > 0.0f ? 1.0f / p_max : 0.0f;
          const float ties[3] = {kd[0] == p_max ? 1.f : 0.f,
                                 kd[1] == p_max ? 1.f : 0.f,
                                 kd[2] == p_max ? 1.f : 0.f};
          const float tie_n = ties[0] + ties[1] + ties[2];
          const float wU = w[0] * U[0] + w[1] * U[1] + w[2] * U[2];
          const float amax_term = -inv_p * wU / fmaxf(tie_n, 1.0f);
          const int mat = static_cast<int>(__ldg(g + C_MESH));
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float wT = w[ch] * T[ch];
            const float g_kd =
                wT * A[ch] +
                (kd[ch] > 0.0f ? w[ch] * U[ch] / fmaxf(kd[ch], 1e-30f)
                               : 0.0f) +
                ties[ch] * amax_term;
            atomicAdd(sacc + ch * kMLanes + mat, static_cast<double>(g_kd));
            atomicAdd(sacc + (3 + ch) * kMLanes + mat,
                      static_cast<double>(wT * em_scale));
            ek[ch] += wT * kd[ch] * sum_scale;
          }
        }
      }
    }

    // Russian roulette + cosine bounce
    uint32_t a = upix, b = site_sd, c = 0x5EEDu, d = p.seed;
    pcg4d(a, b, c, d);
    const float u_rr = u01(a), u1 = u01(b), u2 = u01(c);
    const float p_cont = fmaxf(fmaxf(kd[0], kd[1]), kd[2]);
    if (hit && depth < p.max_depth && u_rr <= p_cont) {
      const float inv_p = p_cont > 0.0f ? 1.0f / p_cont : 0.0f;
      const float sin_th = sqrtf(u1);
      const float cos_th = sqrtf(fmaxf(1.0f - u1, 0.0f));
      const float psi = u2 * 6.28318548202514648f;  // float32(2 pi)
      float t1x = snz, t1y = 0.0f, t1z = -snx;
      if (t1x * t1x + t1z * t1z == 0.0f) {
        t1x = -sny;
        t1y = snx;
      }
      norm3(t1x, t1y, t1z);
      const float btx = sny * t1z - snz * t1y;
      const float bty = snz * t1x - snx * t1z;
      const float btz = snx * t1y - sny * t1x;
      const float ca = sin_th * cosf(psi);
      const float cb = sin_th * sinf(psi);
      r.dx = ca * t1x + cb * btx + cos_th * snx;
      r.dy = ca * t1y + cb * bty + cos_th * sny;
      r.dz = ca * t1z + cb * btz + cos_th * snz;
      r.ox = hx + snx * kBias;
      r.oy = hy + sny * kBias;
      r.oz = hz + snz * kBias;
      T[0] = T[0] * kd[0] * inv_p;
      T[1] = T[1] * kd[1] * inv_p;
      T[2] = T[2] * kd[2] * inv_p;
      ++depth;
    } else {
      // terminate: regenerate as the lane's next sample
      if (kMode == kForwardLs) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          p.ls[(3 * samp + ch) * n_pix + pix] = Ls[ch];
          Ls[ch] = 0.f;
        }
      }
      ++samp;
      depth = 0;
      T[0] = T[1] = T[2] = 1.0f;
      if (samp < p.samples) {
        primary(cam, p.seed, p.W, p.H, pix, samp, r);
        if (kMode == kReplay) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            U[ch] = __ldg(p.ls + (3 * samp + ch) * n_pix + pix);
        }
      }
    }
  }
  if (kMode != kReplay) {
    const float inv_s = static_cast<float>(1.0 / p.samples);
    float* out = p.out + 3 * (pix - p.pix_base);
    out[0] = acc[0] * inv_s;
    out[1] = acc[1] * inv_s;
    out[2] = acc[2] * inv_s;
  }
}

}  // namespace orion
