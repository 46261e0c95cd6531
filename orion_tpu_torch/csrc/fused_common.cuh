// Shared device code of the path kernels (fused_path.cu, prb.cu,
// bvh_path.cu, bounce.cu, through render_lane.cuh), the Whitted kernels
// (whitted.cu, bvh_whitted.cu, through whitted_common.cuh) and the
// wavefront's walk kernels (bvh_intersect.cu, bvh_g8.cu, binned.cu): PCG4D,
// the Woop test, the nearest-hit and any-hit sweeps over a triangle table
// (`Geo`: the chunked sweeps of kernel 4's `WGeo`, whitted.cu), the
// skip-pointer walk over a flattened tree (`Tree`: nearest and any hit),
// primary rays, and what the path lane loop
// (render_lane.cuh's `render_lanes`) computes at a path vertex: the NEE
// (`nee`, the legacy form over a tree) and a bounce's contribution
// (`bounce_contrib`).
//
// The training pairs (prb.cu: 3a/3b over a table, 9a/9b over a tree) run
// `render_lanes` twice, as the forward and as the replay. Both must
// compute every bounce's contribution bit for bit alike, or the replay's
// remaining radiance U = L_s - sum of contributions drifts: they are two
// instantiations of one loop, and the contribution, the running sums and U
// are computed with __fmul_rn/__fadd_rn/__fsub_rn, which the compiler never
// contracts into an FMA, so no context-dependent contraction can make them
// differ.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace orion {

constexpr int kThreads = 128;
constexpr int kChunk = 512;          // FUSED_CHUNK
constexpr int kCols = 32;            // path table row width
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

// Woop test of one row; returns the masked t, and (u, v) on request.
// kF4 reads the row's 13 floats as four float4 (bytes 0-63 of a row that
// starts on 16 bytes, the same two sectors): the same arithmetic in the
// same order, so the same t, u and v (the bounce walk and shade kernels).
template <bool kGlobal, bool kF4 = false>
__device__ __forceinline__ float woop(const float* w, const Ray& r,
                                      float* u_out = nullptr,
                                      float* v_out = nullptr) {
  // named scalars, not an array filled by an unrolled loop: the loop
  // changed the machine code of the kernels that load the row as scalars
  float w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11, w12;
  if (kF4) {
    const float4* q = reinterpret_cast<const float4*>(w);
    const float4 a = kGlobal ? __ldg(q) : q[0];
    const float4 b = kGlobal ? __ldg(q + 1) : q[1];
    const float4 c = kGlobal ? __ldg(q + 2) : q[2];
    w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = b.x; w5 = b.y;
    w6 = b.z; w7 = b.w; w8 = c.x; w9 = c.y; w10 = c.z; w11 = c.w;
    w12 = (kGlobal ? __ldg(q + 3) : q[3]).x;
  } else {
    w0 = ld<kGlobal>(w + 0); w1 = ld<kGlobal>(w + 1);
    w2 = ld<kGlobal>(w + 2); w3 = ld<kGlobal>(w + 3);
    w4 = ld<kGlobal>(w + 4); w5 = ld<kGlobal>(w + 5);
    w6 = ld<kGlobal>(w + 6); w7 = ld<kGlobal>(w + 7);
    w8 = ld<kGlobal>(w + 8); w9 = ld<kGlobal>(w + 9);
    w10 = ld<kGlobal>(w + 10); w11 = ld<kGlobal>(w + 11);
    w12 = ld<kGlobal>(w + 12);
  }
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

// the test on a row's four float4 a = w0..3, b = w4..7, c = w8..11,
// e.x = w12 (binned.cu holds them in four planes)
__device__ __forceinline__ float woop_t_rn(const float4 a, const float4 b,
                                           const float4 c, const float4 e,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz) {
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
__device__ __forceinline__ float woop_t_rn(const float4* row, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz) {
  const float4 a = kGlobal ? __ldg(row) : row[0];
  const float4 b = kGlobal ? __ldg(row + 1) : row[1];
  const float4 c = kGlobal ? __ldg(row + 2) : row[2];
  const float4 e = kGlobal ? __ldg(row + 3) : row[3];
  return woop_t_rn(a, b, c, e, ox, oy, oz, dx, dy, dz);
}

template <bool kGlobal, bool kF4 = false>
__device__ __forceinline__ void sweep_rows(const float* geo, int stride,
                                           int lo, int hi, const Ray& r,
                                           float& t_best, int& row_best) {
  for (int k = lo; k < hi; ++k) {
    const float t = woop<kGlobal, kF4>(geo + k * stride, r);
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

// nearest row with t < cap (ties -> min row), or -1, chunk by chunk from
// global memory (a table past one chunk; kernel 4 sweeps a resident one
// from shared memory, whitted.cu)
template <int kStride>
__device__ __forceinline__ int nearest(const Geo& g, const Ray& r, float cap,
                                       float& t) {
  float t_best = cap;
  int row = -1;
  for (int k = 0; k < g.n_chunks; ++k) {
    if (box_reachable(g, k, r, t_best))
      sweep_rows<true>(g.tab, kStride, k * kChunk, (k + 1) * kChunk, r,
                       t_best, row);
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
__device__ __forceinline__ bool any_hit(const Geo& g, const Ray& r) {
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
// flattened order. `sgeo` is unused (nothing is staged for a tree). kF4:
// leaf rows read as four float4 (`woop`'s; TreeF4's walks).
template <int kStride, bool kF4 = false>
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
                     sweep_rows<true, kF4>(g.tab, kStride, lo,
                                           lo + g.leaf_width, r, tb, rb);
                   });
  t = t_best;
  return row;
}

// does the ray hit any row of the tree at any t >= 0? Leaves at the first
// hit (the reference's shadow test, raytracer.cpp:196-201). kF4 as in
// nearest.
template <int kStride, bool kF4 = false>
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
                      if (woop<true, kF4>(g.tab + k * kStride, r) < kBig) {
                        rb = k;
                        return;
                      }
                  });
  return row >= 0;
}

// A Tree whose leaf rows are read as four float4 (`woop`'s kF4: the same
// arithmetic, so the same t, u and v, and the same winners as Tree's): the
// BVH Whitted kernels' (bvh_whitted.cu), whose row strides (40 or 48
// floats) keep every row on 16 bytes.
struct TreeF4 : Tree {};

template <int kStride>
__device__ __forceinline__ int nearest(const TreeF4& g, const float* sgeo,
                                       const Ray& r, float cap, float& t) {
  return nearest<kStride, true>(static_cast<const Tree&>(g), sgeo, r, cap,
                                t);
}

template <int kStride>
__device__ __forceinline__ bool any_hit(const TreeF4& g, const float* sgeo,
                                        const Ray& r) {
  return any_hit<kStride, true>(static_cast<const Tree&>(g), sgeo, r);
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
// a path vertex of the lane loop (render_lane.cuh)
// ---------------------------------------------------------------------------

template <class G>
struct PathParamsT {
  const float* cam;   // [12] origin | front | right | up
  G geo;              // RGeo: [T_pad, 32] table; Tree: nodes + bundled table
  const float* em;    // [n_em, 160]
  float* out;         // [n_pix, 3] radiance / spp (render, forward)
  float* ls;          // [3S, n_pix] per-sample radiance (forward out,
                      // replay in)
  const float* w;     // [n_pix, 3] per-lane adjoint (replay)
  int n_em, W, H, samples, max_depth, light_samples;
  uint32_t seed;
  int pix_base = 0;   // global pixel of out's first row (a tile's offset)
};

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

// Next-event estimation at hit point h, the legacy form (kernels 8, 9a,
// 9b over a tree; render_lane.cuh's `nee_pairs` is the same over a swept
// table, and `nee_fast_pairs` is kernel 1's fast-shadow form): the shadow
// sweep runs for every sample, and the light normal (at the winner's u, v)
// and the emitted color are the shadow winner's. Returns A (NEE radiance
// without the surface kd) and sum(scale).
template <class P>
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
      float ts;
      const int srow = nearest<kCols>(p.geo, sgeo, sray, kNeeTCap, ts);
      if (srow < 0) continue;
      const float* gs = p.geo.tab + srow * kCols;
      if (__ldg(gs + C_MESH) != mesh) continue;
      float su, sv;
      woop<true>(gs, sray, &su, &sv);
      const float sw = 1.0f - su - sv;
      float lnx = sw * __ldg(gs + C_N0) + su * __ldg(gs + C_N1) +
                  sv * __ldg(gs + C_N2);
      float lny = sw * __ldg(gs + C_N0 + 1) + su * __ldg(gs + C_N1 + 1) +
                  sv * __ldg(gs + C_N2 + 1);
      float lnz = sw * __ldg(gs + C_N0 + 2) + su * __ldg(gs + C_N1 + 2) +
                  sv * __ldg(gs + C_N2 + 2);
      norm3(lnx, lny, lnz);
      const float ske0 = __ldg(gs + C_KE), ske1 = __ldg(gs + C_KE + 1),
                  ske2 = __ldg(gs + C_KE + 2);
      const float cos_l = -(lnx * ldx + lny * ldy + lnz * ldz);
      const float geom = fmaxf(cos_s * cos_l, 0.0f);
      const float d2 = sdx * sdx + sdy * sdy + sdz * sdz;
      const float scale = geom * __ldg(L + 9) / (1.0f + d2) * inv_ls;
      A[0] = __fadd_rn(A[0], __fmul_rn(ske0, scale));
      A[1] = __fadd_rn(A[1], __fmul_rn(ske1, scale));
      A[2] = __fadd_rn(A[2], __fmul_rn(ske2, scale));
      sum_scale = __fadd_rn(sum_scale, scale);
    }
  }
}

}  // namespace orion
