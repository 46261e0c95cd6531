// The persistent lane loop of the path megakernels, and the swept table's
// geometry. `render_lanes` runs kernel 1 (fused_path.cu, a triangle table)
// and kernel 8 (bvh_path.cu, a BVH), and prb.cu's two training pairs: 3a
// and 3b over a triangle table, 9a and 9b over a BVH (the forward and the
// replay of each). `RGeo` (below) is the table of kernels 1, 3a and 3b:
// staged float4 rows and a division-free row test.
//
// `render_lanes` is the radiance / spp estimator of
// orion_tpu/ops/pallas_fused.py::_make_regen_body: PCG4D-jittered primary
// ray, nearest hit, depth-0 emission, next-event estimation, Russian
// roulette on max(kd), cosine bounce, regeneration onto the pixel's next
// sample. The NEE: kernel 1's fast-shadow form is `nee_fast_pairs` (below);
// the legacy form is `nee_pairs` (below) over a table (3a, 3b) and `nee` of
// fused_common.cuh over a tree (8, 9a, 9b), the same terms; over a table
// both forms sweep the rows once for two light samples (`nearest_pair`). The
// geometry `G` (`RGeo`, or fused_common.cuh's `Tree`) supplies
// `nearest<kCols>` and the table of winner attributes (`p.geo.tab`). Its
// mode (kRender, kForwardLs, kReplay) adds the training pairs' records at
// compile time.
//
// Persistent lanes. A thread renders one pixel's samples in sample order,
// writes the pixel, and takes the next pixel from a global counter
// (`take_lane`: one atomic a warp for all its lanes that finish together),
// until the counter passes the pixels to render; the grid is as many
// blocks as stay resident (`persistent_blocks`). With one pixel per thread
// a warp ran as long as its slowest pixel and a finished lane idled (23% of
// the lane slots at the main path's shapes, PERF.md). A pixel's
// radiance, L_s and adjoint terms are the same whichever thread runs it,
// so the image is a pure function of the seed, and a tile renders the
// whole image's pixels.
//
// Instrumented build (-DORION_PATH_COUNTERS, made by tools/path_probe.py,
// never by ops/cuda_build.py): every lane adds its clock64() cycles in the
// nearest-hit queries, in NEE, in the replay's adjoint accumulation
// (with its collisions, `pc_acc_vote`), and in all to `g_path_counters`;
// the lowest active lane of a warp counts the warp's loop iterations and
// their active lanes (__popc(__activemask())), and the kernel records per
// warp and per block the cycles from the first lane running out of pixels
// to the last; kernel 1's NEE counts its paired shadow sweeps' warp
// entries and active lanes, and each lane in one whether it needs both
// samples' winners or one.
// `path_counters_read` / `path_counters_reset` (extern "C", below) read
// and clear them.

#pragma once

#include <type_traits>

#include "fused_common.cuh"

namespace orion {

// Resident blocks an SM that the path kernels are built for
// (__launch_bounds__): 6 caps a thread at 80 registers; measured on the
// H100 (PERF.md) against the 96 the compiler takes by itself for kernel 8
// (5 blocks) and 64 (8 blocks, which spill).
constexpr int kPathBlocks = 6;

#ifdef ORION_PATH_COUNTERS
enum PathCounter {
  kPcLaneCycles,    // cycles from a thread's start to its exit, summed
  kPcNearestCycles, // cycles in the path vertex's nearest-hit query
  kPcNeeCycles,     // cycles in NEE (its shadow queries included)
  kPcIters,         // warp iterations of the lane loop
  kPcIterLanes,     // active lanes summed over those iterations
  kPcNeeIters,      // warp entries into NEE
  kPcNeeLanes,      // active lanes summed over those entries
  kPcWarpTail,      // cycles from a warp's first lane out of pixels to its last
  kPcWarps,
  kPcBlockTail,     // the same per block
  kPcBlocks,
  kPcLanes,         // threads
  kPcAccCycles,     // cycles in the replay's adjoint accumulation
  kPcAccEntries,    // warp entries into it
  kPcAccLanes,      // active lanes summed over those entries
  kPcAccGroups,     // distinct materials summed over those entries
  kPcAccPeers,      // each lane's count of lanes on its material, summed
  kPcAccMax,        // the largest such count of each entry, summed
  kPcPairIters,     // warp entries into kernel 1's paired shadow sweep
  kPcPairLanes,     // active lanes summed over those entries
  kPcPairBoth,      // of those lanes, the ones needing both samples' winners
  kPcPairOne,       // the ones needing one (the other draw is gated)
  kPcCount
};
__device__ unsigned long long g_path_counters[kPcCount];

struct LaneCounters {
  long long t_start = 0, t_done = 0, nearest = 0, nee = 0, acc = 0;
  unsigned long long iters = 0, iter_lanes = 0, nee_iters = 0,
                     nee_lanes = 0, acc_entries = 0, acc_lanes = 0,
                     acc_groups = 0, acc_peers = 0, acc_max = 0,
                     pair_iters = 0, pair_lanes = 0, pair_both = 0,
                     pair_one = 0;
};

__device__ __forceinline__ void pc_warp_vote(unsigned long long& iters,
                                             unsigned long long& lanes) {
  const unsigned m = __activemask();
  if ((threadIdx.x & 31) == __ffs(m) - 1) {
    ++iters;
    lanes += __popc(m);
  }
}

// a thread's sums, once at its exit
__device__ __forceinline__ void pc_flush(const LaneCounters& c) {
  unsigned long long* g = g_path_counters;
  atomicAdd(g + kPcLaneCycles,
            static_cast<unsigned long long>(clock64() - c.t_start));
  atomicAdd(g + kPcNearestCycles, static_cast<unsigned long long>(c.nearest));
  atomicAdd(g + kPcNeeCycles, static_cast<unsigned long long>(c.nee));
  atomicAdd(g + kPcIters, c.iters);
  atomicAdd(g + kPcIterLanes, c.iter_lanes);
  atomicAdd(g + kPcNeeIters, c.nee_iters);
  atomicAdd(g + kPcNeeLanes, c.nee_lanes);
  atomicAdd(g + kPcLanes, 1ull);
  atomicAdd(g + kPcAccCycles, static_cast<unsigned long long>(c.acc));
  atomicAdd(g + kPcAccEntries, c.acc_entries);
  atomicAdd(g + kPcAccLanes, c.acc_lanes);
  atomicAdd(g + kPcAccGroups, c.acc_groups);
  atomicAdd(g + kPcAccPeers, c.acc_peers);
  atomicAdd(g + kPcAccMax, c.acc_max);
  atomicAdd(g + kPcPairIters, c.pair_iters);
  atomicAdd(g + kPcPairLanes, c.pair_lanes);
  atomicAdd(g + kPcPairBoth, c.pair_both);
  atomicAdd(g + kPcPairOne, c.pair_one);
}

// The collisions at the replay's accumulation site, by the lanes that reach
// it together with material `mat`: the lowest of them counts the warp
// entry, its lanes, its distinct materials, the lanes' counts of lanes on
// their material (their mean is the collision degree) and the largest
// count (the rounds that atomics on one address serialise into).
__device__ __forceinline__ void pc_acc_vote(LaneCounters& c, int mat) {
  const unsigned m = __activemask();
  const unsigned peers = __match_any_sync(m, mat);
  const int me = threadIdx.x & 31;
  const unsigned n = __popc(peers);
  const unsigned heads = __ballot_sync(m, me == __ffs(peers) - 1);
  const unsigned sum_n = __reduce_add_sync(m, n);
  const unsigned max_n = __reduce_max_sync(m, n);
  if (me == __ffs(m) - 1) {
    ++c.acc_entries;
    c.acc_lanes += __popc(m);
    c.acc_groups += __popc(heads);
    c.acc_peers += sum_n;
    c.acc_max += max_n;
  }
}

// Exit bookkeeping, by every thread of the block after its lanes are done:
// the spread of `t_done` (when a thread ran out of pixels) over each warp
// and over the block.
__device__ __forceinline__ void pc_exit(long long t_done) {
  __shared__ unsigned long long blk_min, blk_max;
  if (threadIdx.x == 0) {
    blk_min = ~0ull;
    blk_max = 0ull;
  }
  __syncthreads();
  long long lo = t_done, hi = t_done;
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(g_path_counters + kPcWarpTail,
              static_cast<unsigned long long>(hi - lo));
    atomicAdd(g_path_counters + kPcWarps, 1ull);
    atomicMin(&blk_min, static_cast<unsigned long long>(lo));
    atomicMax(&blk_max, static_cast<unsigned long long>(hi));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(g_path_counters + kPcBlockTail, blk_max - blk_min);
    atomicAdd(g_path_counters + kPcBlocks, 1ull);
  }
}

#define ORION_PC(...) __VA_ARGS__
#define ORION_PC_ARG , LaneCounters& pc
#else
#define ORION_PC(...)
#define ORION_PC_ARG
#endif

// ---------------------------------------------------------------------------
// the swept table of kernels 1, 3a and 3b
// ---------------------------------------------------------------------------

// `Geo`'s [T_pad, 32] table and chunk AABBs under their own sweep
// (`nearest` below). Tables up to one chunk (512 rows) are staged once per
// resident block into shared memory (`stage_rows`): a row's first 16
// floats (the 13 Woop floats) as four float4, read by broadcast as four
// 128-bit loads, and only the rows up to the last real one (a padding row
// has |n|^2 = 0), which the staging counts. Larger tables are read through
// the read-only cache in 512-row chunks, each chunk's AABB slab-tested
// against the lane's live segment [0, t_best) and skipped when the lane
// cannot improve. The row test (`test_row`) works in the numerator domain:
// with D = |dw| and n = t D, u D, v D sign-corrected by one xor each, it
// needs no division per row, and a row replaces the best (n_b, D_b) iff
// n D_b < n_b D; rows are swept in order, so ties keep the smaller row. The
// winner's t = n_b / D_b is -ow / dw of that row, bit for bit as the Woop
// test computes it. Both NEE forms sweep the rows for two shadow rays a
// pass (`nearest_pair`: kernel 1's `nee_fast_pairs`, 3a/3b's `nee_pairs`);
// the legacy winner's u, v come from `woop` on its global row.
struct RGeo : Geo {};

// Shared-memory image of a resident table: one float4 header (x: the rows
// to sweep, as int bits), then per row its first 16 floats as four float4.
__device__ __forceinline__ void stage_rows(const RGeo& g, float4* s) {
  if (!g.resident()) return;
  int* n_rows = reinterpret_cast<int*>(s);
  if (threadIdx.x == 0) *n_rows = 0;
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(g.tab);
  for (int k = threadIdx.x; k < g.T_pad * 4; k += blockDim.x) {
    const int row = k >> 2, q = k & 3;
    const float4 v = __ldg(src + row * (kCols / 4) + q);
    s[1 + k] = v;
    if (q == 3 && v.x > 0.0f) atomicMax(n_rows, row + 1);  // |n|^2 > 0
  }
  __syncthreads();
}

// One row's test in the numerator domain (see RGeo); a = w0-3,
// b = w4-7, c = w8-11, e.x = w12. Replaces (bn, bd, brow) when row k is
// hit at t in [0, bn / bd).
__device__ __forceinline__ void test_row(const float4 a, const float4 b,
                                         const float4 c, const float4 e,
                                         const Ray& r, int k, float& bn,
                                         float& bd, int& brow) {
  const float ou = a.x * r.ox + a.y * r.oy + a.z * r.oz + c.y;
  const float ov = a.w * r.ox + b.x * r.oy + b.y * r.oz + c.z;
  const float ow = b.z * r.ox + b.w * r.oy + c.x * r.oz + c.w;
  const float du = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  const float dv = a.w * r.dx + b.x * r.dy + b.y * r.dz;
  const float dw = b.z * r.dx + b.w * r.dy + c.x * r.dz;
  const unsigned s = __float_as_uint(dw) & 0x80000000u;
  const float n = __uint_as_float(__float_as_uint(ow) ^ s ^ 0x80000000u);
  const float un = __uint_as_float(__float_as_uint(ou * dw - ow * du) ^ s);
  const float vn = __uint_as_float(__float_as_uint(ov * dw - ow * dv) ^ s);
  const float d = fabsf(dw);
  const bool ok = (d * e.x > kMtEps) && (un >= 0.0f) && (vn >= 0.0f) &&
                  (un + vn <= d) && (n >= 0.0f) && (n * bd < bn * d);
  bn = ok ? n : bn;
  bd = ok ? d : bd;
  brow = ok ? k : brow;
}

// nearest row with t < cap (ties -> min row), or -1
template <int kStride>
__device__ __forceinline__ int nearest(const RGeo& g, const float* sgeo,
                                       const Ray& r, float cap, float& t) {
  float bn = cap, bd = 1.0f;
  int row = -1;
  if (g.resident()) {
    const float4* rows = reinterpret_cast<const float4*>(sgeo) + 1;
    const int n = *reinterpret_cast<const int*>(sgeo);
#pragma unroll 2
    for (int k = 0; k < n; ++k)
      test_row(rows[4 * k], rows[4 * k + 1], rows[4 * k + 2],
               rows[4 * k + 3], r, k, bn, bd, row);
  } else {
    const float4* src = reinterpret_cast<const float4*>(g.tab);
    for (int c = 0; c < g.n_chunks; ++c) {
      if (!box_reachable(g, c, r, row < 0 ? cap : bn / bd)) continue;
      for (int k = c * kChunk; k < (c + 1) * kChunk; ++k) {
        const float4* w = src + k * (kCols / 4);
        test_row(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3), r, k,
                 bn, bd, row);
      }
    }
  }
  t = row < 0 ? cap : bn / bd;
  return row;
}

// The winners (row with t < cap, ties -> min row, or -1) of two rays of
// one origin, in one pass over the rows: each row is loaded once and
// tested against both rays, and each ray keeps its own best, chunk cull
// included, so each winner is nearest()'s for that ray bit for bit.
__device__ __forceinline__ void nearest_pair(const RGeo& g, const float* sgeo,
                                             const Ray& r0, const Ray& r1,
                                             float cap, int& w0, int& w1) {
  float bn0 = cap, bd0 = 1.0f, bn1 = cap, bd1 = 1.0f;
  w0 = w1 = -1;
  if (g.resident()) {
    const float4* rows = reinterpret_cast<const float4*>(sgeo) + 1;
    const int n = *reinterpret_cast<const int*>(sgeo);
    for (int k = 0; k < n; ++k) {
      const float4 a = rows[4 * k], b = rows[4 * k + 1], c = rows[4 * k + 2],
                   e = rows[4 * k + 3];
      test_row(a, b, c, e, r0, k, bn0, bd0, w0);
      test_row(a, b, c, e, r1, k, bn1, bd1, w1);
    }
  } else {
    const float4* src = reinterpret_cast<const float4*>(g.tab);
    for (int c = 0; c < g.n_chunks; ++c) {
      const bool k0 = box_reachable(g, c, r0, w0 < 0 ? cap : bn0 / bd0);
      const bool k1 = box_reachable(g, c, r1, w1 < 0 ? cap : bn1 / bd1);
      if (!k0 && !k1) continue;
      for (int k = c * kChunk; k < (c + 1) * kChunk; ++k) {
        const float4* w = src + k * (kCols / 4);
        const float4 a = __ldg(w), b = __ldg(w + 1), cc = __ldg(w + 2),
                     e = __ldg(w + 3);
        if (k0) test_row(a, b, cc, e, r0, k, bn0, bd0, w0);
        if (k1) test_row(a, b, cc, e, r1, k, bn1, bd1, w1);
      }
    }
  }
}

// One light sample of the NEE: the sampled emitter triangle `L`, the
// sampled point's barycentrics (la, lb) on it, the shadow ray's direction
// s (unnormalised, to the sampled point), its normalised copy l and cos at
// the surface. `nee`'s arithmetic, op by op (nee does not call these two:
// written over them, it compiled kernel 8 with other registers, PERF.md).
struct ShadowDraw {
  const float* L;
  float la, lb, sdx, sdy, sdz, ldx, ldy, ldz, cos_s;
};

template <class P>
__device__ __forceinline__ ShadowDraw shadow_draw(
    const P& p, const float* E, int count, uint32_t upix, uint32_t site_sd,
    int site, float hx, float hy, float hz, float snx, float sny,
    float snz) {
  uint32_t a = upix, b = site_sd,
           c = 0x11u + 0x101u * static_cast<uint32_t>(site), d = p.seed;
  pcg4d(a, b, c, d);
  const float ut = u01(a), ua = u01(b), ub = u01(c);
  const int sel = min(static_cast<int>(ut * static_cast<float>(count)),
                      count - 1);
  ShadowDraw s;
  s.L = E + kEmHeader + kEmTri * sel;
  const float* L = s.L;
  const bool flip = (ua + ub) > 1.0f;
  const float la = flip ? 1.0f - ua : ua;
  const float lb = flip ? 1.0f - ub : ub;
  s.la = la;
  s.lb = lb;
  s.sdx = __ldg(L + 0) + la * __ldg(L + 3) + lb * __ldg(L + 6) - hx;
  s.sdy = __ldg(L + 1) + la * __ldg(L + 4) + lb * __ldg(L + 7) - hy;
  s.sdz = __ldg(L + 2) + la * __ldg(L + 5) + lb * __ldg(L + 8) - hz;
  s.ldx = s.sdx; s.ldy = s.sdy; s.ldz = s.sdz;
  norm3(s.ldx, s.ldy, s.ldz);
  s.cos_s = snx * s.ldx + sny * s.ldy + snz * s.ldz;
  return s;
}

// The light sample's term, its shadow winner `srow` given: nothing unless
// the winner lies on the sampled mesh; else the light normal at the
// winner's u, v and its emitted color, added to A and sum(scale) as `nee`
// adds them.
template <class P>
__device__ __forceinline__ void shadow_term(const P& p, const ShadowDraw& s,
                                            const Ray& sray, int srow,
                                            float mesh, float inv_ls,
                                            float A[3], float& sum_scale) {
  if (srow < 0) return;
  const float* gs = p.geo.tab + srow * kCols;
  if (__ldg(gs + C_MESH) != mesh) return;
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
  const float cos_l = -(lnx * s.ldx + lny * s.ldy + lnz * s.ldz);
  const float geom = fmaxf(s.cos_s * cos_l, 0.0f);
  const float d2 = s.sdx * s.sdx + s.sdy * s.sdy + s.sdz * s.sdz;
  const float scale = geom * __ldg(s.L + 9) / (1.0f + d2) * inv_ls;
  A[0] = __fadd_rn(A[0], __fmul_rn(ske0, scale));
  A[1] = __fadd_rn(A[1], __fmul_rn(ske1, scale));
  A[2] = __fadd_rn(A[2], __fmul_rn(ske2, scale));
  sum_scale = __fadd_rn(sum_scale, scale);
}

// `nee` (the legacy form) over a swept table, two light samples a sweep
// (nearest_pair; an odd last sample sweeps alone): the same draws,
// winners and terms, added in the same order, so A and sum(scale) are
// nee's bit for bit.
template <class P>
__device__ __forceinline__ void nee_pairs(const P& p, const float* sgeo,
                                          uint32_t upix, uint32_t site_sd,
                                          float hx, float hy, float hz,
                                          float gnx, float gny, float gnz,
                                          float snx, float sny, float snz,
                                          float A[3], float& sum_scale) {
  const float inv_ls = static_cast<float>(1.0 / p.light_samples);
  Ray r0, r1;
  r0.ox = r1.ox = hx + kBias * gnx;
  r0.oy = r1.oy = hy + kBias * gny;
  r0.oz = r1.oz = hz + kBias * gnz;
  for (int mi = 0; mi < p.n_em; ++mi) {
    const float* E = p.em + mi * kEmStride;
    const float mesh = __ldg(E);
    const int count = static_cast<int>(__ldg(E + 1));
    for (int ls = 0; ls < p.light_samples; ls += 2) {
      const bool two = ls + 1 < p.light_samples;
      const int site = ls + p.light_samples * mi;
      const ShadowDraw s0 = shadow_draw(p, E, count, upix, site_sd, site, hx,
                                        hy, hz, snx, sny, snz);
      const ShadowDraw s1 = shadow_draw(p, E, count, upix, site_sd,
                                        two ? site + 1 : site, hx, hy, hz,
                                        snx, sny, snz);
      r0.dx = s0.sdx; r0.dy = s0.sdy; r0.dz = s0.sdz;
      r1.dx = s1.sdx; r1.dy = s1.sdy; r1.dz = s1.sdz;
      int w0, w1 = -1;
      if (two) {
        nearest_pair(p.geo, sgeo, r0, r1, kNeeTCap, w0, w1);
      } else {
        float ts;
        w0 = nearest<kCols>(p.geo, sgeo, r0, kNeeTCap, ts);
      }
      shadow_term(p, s0, r0, w0, mesh, inv_ls, A, sum_scale);
      if (two) shadow_term(p, s1, r1, w1, mesh, inv_ls, A, sum_scale);
    }
  }
}

// A light sample of the fast-shadow NEE before its sweep: light normal at
// the sampled point of the emitter triangle, the geometry term, and the
// term's scale; `on` iff the geometry term is > 0 (else the sample adds
// nothing whatever is visible, and its winner is not needed).
struct FastTerm {
  float scale;
  bool on;
};

__device__ __forceinline__ FastTerm fast_term(const ShadowDraw& s,
                                              float inv_ls) {
  const float* L = s.L;
  const float lw = 1.0f - s.la - s.lb;
  float lnx = lw * __ldg(L + 10) + s.la * __ldg(L + 13) + s.lb * __ldg(L + 16);
  float lny = lw * __ldg(L + 11) + s.la * __ldg(L + 14) + s.lb * __ldg(L + 17);
  float lnz = lw * __ldg(L + 12) + s.la * __ldg(L + 15) + s.lb * __ldg(L + 18);
  norm3(lnx, lny, lnz);
  const float cos_l = -(lnx * s.ldx + lny * s.ldy + lnz * s.ldz);
  const float geom = s.cos_s * cos_l;
  FastTerm f{0.0f, geom > 0.0f};
  if (f.on) {
    const float d2 = s.sdx * s.sdx + s.sdy * s.sdy + s.sdz * s.sdz;
    f.scale = geom * __ldg(L + 9) / (1.0f + d2) * inv_ls;
  }
  return f;
}

// the sample's emitted color (the mesh's) times its scale, added to A when
// the sample is on and its shadow winner `srow` lies on the sampled mesh
template <class P>
__device__ __forceinline__ void fast_add(const P& p, const float* E,
                                         float mesh, const FastTerm& f,
                                         int srow, float A[3]) {
  if (!f.on || srow < 0 || __ldg(p.geo.tab + srow * kCols + C_MESH) != mesh)
    return;
  A[0] += __ldg(E + 2) * f.scale;
  A[1] += __ldg(E + 3) * f.scale;
  A[2] += __ldg(E + 4) * f.scale;
}

// The fast-shadow NEE over a swept table (kernel 1): the emitted color and
// the light normal are the sampled emitter triangle's, and a sample is
// visible iff the nearest hit below kNeeTCap lies on the sampled mesh. Two
// light samples of one emissive mesh share one sweep (nearest_pair),
// entered by a lane when either sample's geometry term is > 0; the lane
// keeps the winners of the samples that pass. An odd last sample sweeps
// alone, and only if it passes. The draws, terms and their order in A are
// those of one sweep a sample, and each winner is nearest()'s, so A is the
// same bit for bit. Returns A (NEE radiance without the surface kd).
template <class P>
__device__ __forceinline__ void nee_fast_pairs(
    const P& p, const float* sgeo, uint32_t upix, uint32_t site_sd,
    float hx, float hy, float hz, float gnx, float gny, float gnz, float snx,
    float sny, float snz, float A[3] ORION_PC_ARG) {
  const float inv_ls = static_cast<float>(1.0 / p.light_samples);
  Ray r0, r1;
  r0.ox = r1.ox = hx + kBias * gnx;
  r0.oy = r1.oy = hy + kBias * gny;
  r0.oz = r1.oz = hz + kBias * gnz;
  for (int mi = 0; mi < p.n_em; ++mi) {
    const float* E = p.em + mi * kEmStride;
    const float mesh = __ldg(E);
    const int count = static_cast<int>(__ldg(E + 1));
    for (int ls = 0; ls < p.light_samples; ls += 2) {
      const int site = ls + p.light_samples * mi;
      const ShadowDraw s0 = shadow_draw(p, E, count, upix, site_sd, site, hx,
                                        hy, hz, snx, sny, snz);
      const FastTerm f0 = fast_term(s0, inv_ls);
      r0.dx = s0.sdx; r0.dy = s0.sdy; r0.dz = s0.sdz;
      int w0 = -1;
      if (ls + 1 < p.light_samples) {
        const ShadowDraw s1 = shadow_draw(p, E, count, upix, site_sd,
                                          site + 1, hx, hy, hz, snx, sny,
                                          snz);
        const FastTerm f1 = fast_term(s1, inv_ls);
        r1.dx = s1.sdx; r1.dy = s1.sdy; r1.dz = s1.sdz;
        int w1 = -1;
        if (f0.on || f1.on) {
          ORION_PC(pc_warp_vote(pc.pair_iters, pc.pair_lanes);
                   ++(f0.on && f1.on ? pc.pair_both : pc.pair_one);)
          nearest_pair(p.geo, sgeo, r0, r1, kNeeTCap, w0, w1);
        }
        fast_add(p, E, mesh, f0, w0, A);
        fast_add(p, E, mesh, f1, w1, A);
      } else {
        if (f0.on) {
          float ts;
          w0 = nearest<kCols>(p.geo, sgeo, r0, kNeeTCap, ts);
        }
        fast_add(p, E, mesh, f0, w0, A);
      }
    }
  }
}

// dynamic shared memory of a launch over `g`: stage_rows' image of a
// resident table
inline size_t staged_bytes(const RGeo& g) {
  return g.resident() ? sizeof(float4) * (1 + 4 * g.T_pad) : 0;
}

// the next pixel lane for every active thread of the warp: one atomic for
// all of them, consecutive lanes in lane order
__device__ __forceinline__ int take_lane(int* next) {
  const unsigned m = __activemask();
  const int me = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (me == leader) base = atomicAdd(next, __popc(m));
  base = __shfl_sync(m, base, leader);
  return base + __popc(m & ((1u << me) - 1u));
}

// The block's share of the replay's adjoints at one hit vertex: the six
// terms v (d kd, then d ke, of material `mat`) of every lane that reaches
// this point together are summed, in double, over the lanes of the warp on
// the same material (a pointer-jumping tree along the group:
// ceil(log2(group)) shuffle rounds), and the group's first lane adds the
// sums to the block's [6, kMLanes] accumulator `sacc`: one shared atomic
// per material of the warp and term, where each lane's own atomics
// serialised on the warp's common material. `with_ke`: some lane's d ke
// terms may be nonzero (a depth-0 vertex); else only d kd is summed.
__device__ __forceinline__ void add_adjoint(double* sacc, int mat,
                                            double v[6]) {
  const unsigned m = __activemask();
  const unsigned peers = __match_any_sync(m, mat);
  const int me = threadIdx.x & 31;
  const bool with_ke =
      __any_sync(m, v[3] != 0.0 || v[4] != 0.0 || v[5] != 0.0);
  // the next lane of this lane's group above it, or -1
  int nxt = __ffs(peers & ~((2u << me) - 1u)) - 1;
  while (__any_sync(m, nxt >= 0)) {
    const int src = nxt >= 0 ? nxt : me;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (k < 3 || with_ke) {
        const double x = __shfl_sync(m, v[k], src);
        if (nxt >= 0) v[k] += x;
      }
    }
    const int nn = __shfl_sync(m, nxt, src);
    nxt = nxt >= 0 ? nn : -1;
  }
  if (me == __ffs(peers) - 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (v[k] != 0.0) atomicAdd(sacc + k * kMLanes + mat, v[k]);
  }
}

// Persistent lanes: run pixels p.pix_base + [0, n_lanes), each taken from
// *next (zero at launch). kLegacy picks the NEE form (false: the fast
// shadow test of kernel 1, `nee_fast_pairs`, over a table only; true: the
// legacy NEE of kernels 8, 3a, 3b, 9a, 9b). kMode:
//   kRender    : write each pixel's radiance / spp to p.out (kernels 1, 8);
//   kForwardLs : the same, with each bounce's contribution rounded op by op
//                (bounce_contrib), plus each sample's radiance L_s to
//                p.ls[(3 s + c) * n_lanes + lane] (kernels 3a, 9a: the
//                planes are the launch's tile's);
//   kReplay    : start U at L_s when a sample begins, subtract each
//                bounce's contribution (the forward's own arithmetic) and
//                add the closed-form material adjoints of the lane's
//                adjoint p.w[3 lane + c] (read at each hit, not held in
//                registers) to
//                the block's accumulator `sacc` (add_adjoint)
//                and the NEE emitted-color adjoint to the thread's `ek`
//                (kernels 3b, 9b).
// The training modes are compile-time branches that kRender drops.
template <bool kLegacy, int kMode, class P>
__device__ __forceinline__ void render_lanes(const P& p, const float* sgeo,
                                             int n_lanes, int* next,
                                             double* sacc,
                                             double* ek ORION_PC_ARG) {
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
  // the training modes' plane stride, the tile's lanes; a plane's offset
  // (3 s + c) n_lanes + lane is taken in 64 bits (3 S W H passes 2^31 from
  // 22.4 M pixels at 32 spp)
  const size_t plane = static_cast<size_t>(n_lanes);
  float Ls[3] = {0.f, 0.f, 0.f};    // this sample's radiance (forward)
  float U[3] = {0.f, 0.f, 0.f};     // remaining radiance (replay)
  if constexpr (kMode == kReplay) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) U[ch] = __ldg(p.ls + ch * plane + lane);
  }

  // no `break`: a lane leaves only at the loop's test, so the lanes that
  // stay rejoin there and start every vertex together
  while (lane < n_lanes) {
    ORION_PC(pc_warp_vote(pc.iters, pc.iter_lanes);
             const long long pc0 = clock64();)
    float t;
    const int row = nearest<kCols>(p.geo, sgeo, r, kBig, t);
    ORION_PC(pc.nearest += clock64() - pc0;)
    const bool hit = row >= 0;
    const uint32_t upix = static_cast<uint32_t>(pix);
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
      ORION_PC(pc_warp_vote(pc.nee_iters, pc.nee_lanes);
               const long long pc1 = clock64();)
      if constexpr (!kLegacy)
        nee_fast_pairs(p, sgeo, upix, site_sd, hx, hy, hz, gnx, gny, gnz,
                       snx, sny, snz, A ORION_PC(, pc));
      else if constexpr (std::is_same_v<decltype(P::geo), RGeo>)
        nee_pairs(p, sgeo, upix, site_sd, hx, hy, hz, gnx, gny, gnz, snx,
                  sny, snz, A, sum_scale);
      else
        nee(p, sgeo, upix, site_sd, hx, hy, hz, gnx, gny, gnz, snx, sny,
            snz, A, sum_scale);
      ORION_PC(pc.nee += clock64() - pc1;)
      if constexpr (kMode == kRender) {
        float rr = ke[0] * em_scale, rg = ke[1] * em_scale,
              rb = ke[2] * em_scale;
        rr += kd[0] * A[0]; rg += kd[1] * A[1]; rb += kd[2] * A[2];
        acc[0] += T[0] * rr; acc[1] += T[1] * rg; acc[2] += T[2] * rb;
      } else {
        float c[3];
        bounce_contrib(T, ke, em_scale, kd, A, c);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          if constexpr (kMode == kForwardLs) {
            acc[ch] = __fadd_rn(acc[ch], c[ch]);
            Ls[ch] = __fadd_rn(Ls[ch], c[ch]);
          } else {
            U[ch] = __fsub_rn(U[ch], c[ch]);
          }
        }
      }
      if constexpr (kMode == kReplay) {
        ORION_PC(const long long pc2 = clock64();)
        // closed-form adjoints (pallas_prb.py replay_impl :201-238);
        // p = max(kd) splits a tie evenly over the tied channels. The
        // lane's adjoint is read here, not held in registers.
        const float w[3] = {__ldg(p.w + 3 * lane), __ldg(p.w + 3 * lane + 1),
                            __ldg(p.w + 3 * lane + 2)};
        const float p_max = fmaxf(fmaxf(kd[0], kd[1]), kd[2]);
        const float inv_p = p_max > 0.0f ? 1.0f / p_max : 0.0f;
        const float ties[3] = {kd[0] == p_max ? 1.f : 0.f,
                               kd[1] == p_max ? 1.f : 0.f,
                               kd[2] == p_max ? 1.f : 0.f};
        const float tie_n = ties[0] + ties[1] + ties[2];
        const float wU = w[0] * U[0] + w[1] * U[1] + w[2] * U[2];
        const float amax_term = -inv_p * wU / fmaxf(tie_n, 1.0f);
        const int mat = static_cast<int>(__ldg(g + C_MESH));
        double terms[6];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float wT = w[ch] * T[ch];
          const float g_kd =
              wT * A[ch] +
              (kd[ch] > 0.0f ? w[ch] * U[ch] / fmaxf(kd[ch], 1e-30f)
                             : 0.0f) +
              ties[ch] * amax_term;
          terms[ch] = static_cast<double>(g_kd);
          terms[3 + ch] = static_cast<double>(wT * em_scale);
          ek[ch] += static_cast<double>(wT * kd[ch] * sum_scale);
        }
        ORION_PC(pc_acc_vote(pc, mat);)
        add_adjoint(sacc, mat, terms);
        ORION_PC(pc.acc += clock64() - pc2;)
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
      // sin and cos of psi = 2 pi u2, argument reduced exactly (no slow
      // path to call, so no stack frame for it)
      float sin_psi, cos_psi;
      sincospif(2.0f * u2, &sin_psi, &cos_psi);
      float t1x = snz, t1y = 0.0f, t1z = -snx;
      if (t1x * t1x + t1z * t1z == 0.0f) {
        t1x = -sny;
        t1y = snx;
      }
      norm3(t1x, t1y, t1z);
      const float btx = sny * t1z - snz * t1y;
      const float bty = snz * t1x - snx * t1z;
      const float btz = snx * t1y - sny * t1x;
      const float ca = sin_th * cos_psi;
      const float cb = sin_th * sin_psi;
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
      // terminate: regenerate as the pixel's next sample, or write the
      // pixel and take the next one
      if constexpr (kMode == kForwardLs) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          p.ls[(3 * samp + ch) * plane + lane] = Ls[ch];
          Ls[ch] = 0.f;
        }
      }
      ++samp;
      depth = 0;
      T[0] = T[1] = T[2] = 1.0f;
      if (samp == p.samples) {
        if constexpr (kMode != kReplay) {
          float* out = p.out + 3 * lane;
          out[0] = acc[0] * inv_s;
          out[1] = acc[1] * inv_s;
          out[2] = acc[2] * inv_s;
          acc[0] = acc[1] = acc[2] = 0.f;
        }
        samp = 0;
        lane = take_lane(next);
        pix = p.pix_base + lane;
      }
      if (lane < n_lanes) {
        primary(cam, p.seed, p.W, p.H, pix, samp, r);
        if constexpr (kMode == kReplay) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            U[ch] = __ldg(p.ls + (3 * samp + ch) * plane + lane);
        }
      }
    }
  }
  ORION_PC(pc.t_done = clock64();)
}

// the grid of a persistent launch: as many blocks of kThreads as stay
// resident on the card at `smem` bytes of dynamic shared memory, and no
// more than the lanes need
template <class K>
inline int persistent_blocks(K kernel, size_t smem, int n_lanes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int need = (n_lanes + kThreads - 1) / kThreads;
  return max(1, min(need, per_sm * sms));
}

// out = [resident blocks per SM at `smem` bytes of dynamic shared memory,
// registers per thread, local (spill and stack) bytes per thread, static
// shared bytes] of `kernel` as built
template <class K>
inline int kernel_info(K kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(a.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads,
                                                    smem));
}

}  // namespace orion

#ifdef ORION_PATH_COUNTERS
// the instrumented build's counters (one library per kernel source)
extern "C" int path_counters_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, orion::g_path_counters, sizeof(orion::g_path_counters)));
}
extern "C" int path_counters_reset() {
  const unsigned long long zero[orion::kPcCount] = {};
  return static_cast<int>(cudaMemcpyToSymbol(orion::g_path_counters, zero,
                                             sizeof(zero)));
}
#endif
