// The sorted-wavefront bounce pipeline: three kernels launched once per
// bounce over the live prefix of a [16, N] float32 wavefront state that
// lives in device memory between bounces and is sorted by the host side
// (ops/bounce.py) on the coherence key this file writes into row 13.
//
// Replaces: orion_tpu/ops/pallas_bounce.py
//   bounce_walk_kernel  <- _make_walk_kernel  (:223): the lean nearest-hit
//       walk; state rows 0-5 (origin, direction) and 9 (alive) of the first
//       n lanes -> hitdata [8, n]: t, u, v, global winner row, hit flag,
//       three zero rows. The walk body is pallas_bvh_path.py's `lean`.
//   bounce_vis_kernel   <- _make_vis_kernel   (:285): both light samples'
//       visibility of one emitter in one dual-carry walk (`shadow_em2`'s,
//       in steps), standalone -> [8, n], rows 0-1 the 0/1 visibility
//       planes; its draw-only mode (bounce_draw_kernel, the same launch
//       entry) writes every site's shadow ray instead, for the binned
//       renderer's sweep.
//   bounce_shade_kernel <- _make_shade_kernel (:359): one bounce of the
//       estimator over the walk's hit: depth-0 emission, fast-shadow NEE
//       (its own shadow walks unless the visibility planes are given),
//       Russian roulette, cosine bounce, radiance accumulation and the next
//       bounce's sort key, written over the state's first n lanes in place;
//       templated on whether it also dumps the 15 per-bounce planes the
//       closed-form trainer reads ([16, n]) and on whether the visibility
//       planes (one per emitter and light sample) are given.
//
// State rows: 0-2 origin, 3-5 direction, 6-8 throughput, 9 alive, 10-12
// accumulated radiance, 13 sort key, 14 pixel, 15 sample (the last three
// integer-valued, exact in float32). Lanes past n are never touched, so a
// dead suffix keeps its pixel and radiance.
//
// What differs from the TPU kernels: they walk one pointer per block of
// 512-1024 lanes and receive the winner's 32 attribute columns through a
// gather between walk and shade; here a thread walks one ray at a time
// (its own octant's tree copy when there are eight) and reads its
// winner's 128-byte table row itself. The estimator, its PCG4D sites and
// its tie rules are the same: nearest hit = min t, ties to the smallest
// bundled row inside a leaf and to the earlier leaf across leaves.
//
// What bounds them on the H100: the walks are chains of dependent L2 loads
// (a slab test is 12 FP32 operations on a 32-byte node row, a Woop test 39
// on 52 bytes of a table row; the 34,818-triangle box's tree and table fit
// in the 50 MB L2); the shade kernel besides moves 2 x 64 bytes of state
// and 32 bytes of hit data a lane. What the walk and shade kernels do
// about it (PERF.md): the walk and the vis kernel are persistent and
// refill a warp's lanes as their rays end (a warp ran as long as its
// longest ray: SIMT 0.55 past depth 0, the vis kernel's pairs 0.33-0.40);
// all three read a Woop row as four float4, and the walk and shade are
// built for more resident warps (12 and 10 blocks of 128), which hide
// more of the walks' latency. The walk reads its node rows from L2 near
// its rate (~66 GB a 1080p 16 spp render of the 34,818-triangle box), so
// lane utilisation moves it little. The shade kernel's shadow walk is
// still each lane's own: a block-wide queue of them and persistent shade
// lanes were measured and lost.

#include "render_lane.cuh"

namespace {

using namespace orion;

// Instrumented build (-DORION_BOUNCE_COUNTERS, made by
// tools/bounce_probe.py, never by ops/cuda_build.py): the walk and shade
// kernels add their work and clock64() cycles to `g_bounce_counters`,
// read and cleared by bounce_counters_read / bounce_counters_reset
// (extern "C", below). The walk: rays, node steps and Woop tests summed
// over rays, the warp iterations of the node loop and their active lanes
// (SIMT efficiency). The shade: a thread's cycles in the frame and light
// draws, in the shadow walk and in all; the shadow walk's rays, warp
// entries and their active lanes, loop iterations and their active lanes,
// node steps and Woop tests.
#ifdef ORION_BOUNCE_COUNTERS
enum BounceCounter {
  kBcWalkRays,        // lanes that walked (alive)
  kBcWalkSteps,       // node rows visited, summed over rays
  kBcWalkTests,       // Woop tests, summed over rays
  kBcWalkIters,       // warp iterations of the walk's node loop
  kBcWalkIterLanes,   // active lanes summed over those iterations
  kBcWalkWarps,       // warps that walked
  kBcShadeLanes,      // lanes shaded
  kBcShadeCycles,     // a thread's cycles from start to end, summed
  kBcDrawCycles,      // in the frame and light draws
  kBcShadowCycles,    // in the shadow walk
  kBcShadowRays,      // ray pairs walked (need0 || need1)
  kBcShadowEntries,   // warp entries into the shadow walk
  kBcShadowEntryLanes,  // active lanes summed over those entries
  kBcShadowIters,     // warp iterations of the shadow walk's loop
  kBcShadowIterLanes, // active lanes summed over those iterations
  kBcShadowSteps,     // node rows visited by the pairs
  kBcShadowTests,     // Woop tests of both rays
  kBcShadeWarps,      // warps that shaded
  kBcCount
};
__device__ unsigned long long g_bounce_counters[kBcCount];

__device__ __forceinline__ void bc_add(int k, unsigned long long v) {
  atomicAdd(g_bounce_counters + k, v);
}

// the lowest active lane counts one warp event and its active lanes
__device__ __forceinline__ void bc_vote(int k_events, int k_lanes) {
  const unsigned m = __activemask();
  if ((threadIdx.x & 31) == __ffs(m) - 1) {
    bc_add(k_events, 1ull);
    bc_add(k_lanes, __popc(m));
  }
}

// one warp event, counted by the lowest active lane
__device__ __forceinline__ void bc_warp_once(int k) {
  if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) bc_add(k, 1ull);
}

#define ORION_BC(...) __VA_ARGS__
#else
#define ORION_BC(...)
#endif

constexpr int kMortonBits = 6;
constexpr int kDeadKey = 1 << (3 * kMortonBits + 3);

struct BounceParams {
  Tree geo;
  const float* em;   // [n_em, 160]
  int n_em, light_samples, B_pad, N, n, depth, max_depth;
  uint32_t seed;
  float lo[3], scale[3];   // sort-key quantization of the scene's bounds
};

// what the shade and visibility kernels know of a lane's hit
struct Frame {
  bool hit;
  float hx, hy, hz, snx, sny, snz, gnx, gny, gnz;
  const float* g;   // the winner's table row
};

__device__ __forceinline__ Frame hit_frame(const BounceParams& p,
                                           const float* hd, int i,
                                           const Ray& r) {
  Frame f;
  f.hit = hd[4 * p.n + i] > 0.0f;
  f.g = nullptr;
  if (!f.hit) return f;
  const float t = hd[i], u = hd[p.n + i], v = hd[2 * p.n + i];
  int row = static_cast<int>(hd[3 * p.n + i]);
  row = max(0, min(row, p.B_pad - 1));
  const float* g = p.geo.tab + row * kCols;
  f.g = g;
  f.hx = r.ox + t * r.dx; f.hy = r.oy + t * r.dy; f.hz = r.oz + t * r.dz;
  const float wb = 1.0f - u - v;
  f.snx = wb * __ldg(g + C_N0) + u * __ldg(g + C_N1) + v * __ldg(g + C_N2);
  f.sny = wb * __ldg(g + C_N0 + 1) + u * __ldg(g + C_N1 + 1) +
          v * __ldg(g + C_N2 + 1);
  f.snz = wb * __ldg(g + C_N0 + 2) + u * __ldg(g + C_N1 + 2) +
          v * __ldg(g + C_N2 + 2);
  norm3(f.snx, f.sny, f.snz);
  // geometric normal: the Woop w-row rescaled by |n|
  const float s = sqrtf(__ldg(g + 12));
  f.gnx = __ldg(g + 6) * s; f.gny = __ldg(g + 7) * s; f.gnz = __ldg(g + 8) * s;
  return f;
}

__device__ __forceinline__ Ray lane_ray(const float* st, int N, int i) {
  Ray r;
  r.ox = st[i]; r.oy = st[N + i]; r.oz = st[2 * N + i];
  r.dx = st[3 * N + i]; r.dy = st[4 * N + i]; r.dz = st[5 * N + i];
  return r;
}

// one light sample of emitter record E drawn at hit point h: the shadow
// direction (unnormalized: the sample sits at t == 1), whether the lane
// needs its visibility at all, and the scale it adds if visible
struct LightDraw {
  float sdx, sdy, sdz, scale;
  bool need;
};

__device__ __forceinline__ LightDraw light_draw(const float* E, int site,
                                                uint32_t upix,
                                                uint32_t site_sd,
                                                uint32_t seed, float inv_ls,
                                                const Frame& f) {
  const int count = static_cast<int>(__ldg(E + 1));
  uint32_t a = upix, b = site_sd,
           c = 0x11u + 0x101u * static_cast<uint32_t>(site), d = seed;
  pcg4d(a, b, c, d);
  const float ut = u01(a), ua = u01(b), ub = u01(c);
  const int sel = min(static_cast<int>(ut * static_cast<float>(count)),
                      count - 1);
  const float* L = E + kEmHeader + kEmTri * sel;
  const bool flip = (ua + ub) > 1.0f;
  const float la = flip ? 1.0f - ua : ua;
  const float lb = flip ? 1.0f - ub : ub;
  LightDraw o;
  o.sdx = __ldg(L + 0) + la * __ldg(L + 3) + lb * __ldg(L + 6) - f.hx;
  o.sdy = __ldg(L + 1) + la * __ldg(L + 4) + lb * __ldg(L + 7) - f.hy;
  o.sdz = __ldg(L + 2) + la * __ldg(L + 5) + lb * __ldg(L + 8) - f.hz;
  float ldx = o.sdx, ldy = o.sdy, ldz = o.sdz;
  norm3(ldx, ldy, ldz);
  const float cos_s = f.snx * ldx + f.sny * ldy + f.snz * ldz;
  const float lw = 1.0f - la - lb;
  float lnx = lw * __ldg(L + 10) + la * __ldg(L + 13) + lb * __ldg(L + 16);
  float lny = lw * __ldg(L + 11) + la * __ldg(L + 14) + lb * __ldg(L + 17);
  float lnz = lw * __ldg(L + 12) + la * __ldg(L + 15) + lb * __ldg(L + 18);
  norm3(lnx, lny, lnz);
  const float cos_l = -(lnx * ldx + lny * ldy + lnz * ldz);
  const float geom = cos_s * cos_l;
  o.need = geom > 0.0f;   // else it adds 0 whatever is visible: no walk
  const float d2 = o.sdx * o.sdx + o.sdy * o.sdy + o.sdz * o.sdz;
  o.scale = geom * __ldg(L + 9) / (1.0f + d2) * inv_ls;
  return o;
}

__device__ __forceinline__ bool slab_hit(const float4& n0, const float4& n1,
                                         const Ray& r, float ix, float iy,
                                         float iz, float t_best) {
  const float tx0 = (n0.x - r.ox) * ix, tx1 = (n0.w - r.ox) * ix;
  const float ty0 = (n0.y - r.oy) * iy, ty1 = (n1.x - r.oy) * iy;
  const float tz0 = (n0.z - r.oz) * iz, tz1 = (n1.y - r.oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fmaxf(tz0, tz1));
  return (tmax >= tmin) && (tmax > 0.0f) && (tmin < t_best);
}

// Does the nearest hit below kNeeTCap lie on `mesh`? The lean single walk
// (`shadow_em`): the nearest-hit walk, then the winner's mesh column.
__device__ __forceinline__ bool shadow_em(const Tree& g, const Ray& r,
                                          float mesh) {
  float t;
  const int row = nearest<kCols>(g, nullptr, r, kNeeTCap, t);
  return row >= 0 && __ldg(g.tab + row * kCols + C_MESH) == mesh;
}

// The same question for two rays that leave one origin, behind ONE pointer
// (`shadow_em2`): each ray carries (t_best, emitter flag); a node is
// entered when either ray's live segment slab-hits it; a ray that needs no
// answer starts at t = -kBig and never votes. Bit 0 of a leaf's start says
// the leaf holds no emitter rows: an improving hit there clears the flag
// without reading the row's mesh. With eight tree copies r0's octant's
// copy serves both rays. A row is read as four float4. The vis kernel
// walks the same pairs in steps, in its own loop.
__device__ __forceinline__ void shadow_em2(const Tree& g, const Ray& r0,
                                           const Ray& r1, bool need0,
                                           bool need1, float mesh, bool& vis0,
                                           bool& vis1) {
  float tb0 = need0 ? kNeeTCap : -kBig, tb1 = need1 ? kNeeTCap : -kBig;
  bool em0 = false, em1 = false;
  const float ix0 = 1.0f / r0.dx, iy0 = 1.0f / r0.dy, iz0 = 1.0f / r0.dz;
  const float ix1 = 1.0f / r1.dx, iy1 = 1.0f / r1.dy, iz1 = 1.0f / r1.dz;
  int ptr = 0;
  if (g.copies == 8)
    ptr = g.M * ((r0.dx >= 0.0f ? 1 : 0) + (r0.dy >= 0.0f ? 2 : 0) +
                 (r0.dz >= 0.0f ? 4 : 0));
  const int end = ptr + g.M;
  ORION_BC(bc_vote(kBcShadowEntries, kBcShadowEntryLanes);
           bc_add(kBcShadowRays, 1ull);
           unsigned steps = 0, tests = 0;)
  while (ptr < end) {
    ORION_BC(bc_vote(kBcShadowIters, kBcShadowIterLanes); ++steps;)
    const float4 n0 = __ldg(g.nodes + 2 * ptr);
    const float4 n1 = __ldg(g.nodes + 2 * ptr + 1);
    const bool hit = slab_hit(n0, n1, r0, ix0, iy0, iz0, tb0) ||
                     slab_hit(n0, n1, r1, ix1, iy1, iz1, tb1);
    const int start = __float_as_int(n1.w);
    if (hit && start >= 0) {
      const int lo = start & ~1;
      const bool no_em = (start & 1) != 0;
      for (int k = lo; k < lo + g.leaf_width; ++k) {
        const float* w = g.tab + k * kCols;
        ORION_BC(tests += (need0 ? 1u : 0u) + (need1 ? 1u : 0u);)
        if (need0) {
          const float t = woop<true, true>(w, r0);
          if (t < tb0) {   // strict: the smallest row, the earlier leaf
            tb0 = t;
            em0 = !no_em && __ldg(w + C_MESH) == mesh;
          }
        }
        if (need1) {
          const float t = woop<true, true>(w, r1);
          if (t < tb1) {
            tb1 = t;
            em1 = !no_em && __ldg(w + C_MESH) == mesh;
          }
        }
      }
    }
    ptr = (hit && start < 0) ? ptr + 1 : __float_as_int(n1.z);
  }
  ORION_BC(bc_add(kBcShadowSteps, steps); bc_add(kBcShadowTests, tests);)
  vis0 = need0 && em0;
  vis1 = need1 && em1;
}

// Resident blocks an SM that the walk kernel (6a) is built for
// (__launch_bounds__), the active lanes below which a warp refills, and
// the node steps a walking lane takes between two refill votes, each leaf
// the ray hits tested where it is met (the tight loop of walk_tree). All
// three measured on the H100 (PERF.md; tools/bounce_probe.py --sweep
// builds copies of this source with other values).
constexpr int kWalkBlocks = 12;
constexpr int kWalkRefill = 16;
constexpr int kWalkSteps = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// one lane's hitdata column: t, u, v, winner row, hit flag, three zeros
__device__ __forceinline__ void write_hit(float* hd, int n, int i, float t,
                                          float u, float v, int row) {
  const bool hit = row >= 0;
  hd[i] = hit ? t : kBig;
  hd[n + i] = hit ? u : 0.0f;
  hd[2 * n + i] = hit ? v : 0.0f;
  hd[3 * n + i] = hit ? static_cast<float>(row) : 0.0f;
  hd[4 * n + i] = hit ? 1.0f : 0.0f;
  hd[5 * n + i] = 0.0f;
  hd[6 * n + i] = 0.0f;
  hd[7 * n + i] = 0.0f;
}

// Kernel 6a: a persistent walk that refills its lanes (after Aila &
// Laine, HPG 2009) over the live prefix. The grid is as many blocks as
// stay resident; a thread walks one ray at a time and, when it is done,
// writes the ray's hitdata and goes idle. A warp refills when fewer than
// kWalkRefill of its lanes still walk: every idle lane takes the next lane
// of the prefix from the counter *next (zero at launch; take_lane: one
// atomic a warp, consecutive lanes, so the sort's coherence reaches each
// warp), and a lane that is not alive writes a miss at once. Between two
// votes a walking lane visits up to kWalkSteps nodes and tests the rows
// of each leaf it hits where it meets it (a vote every node cost more
// than the lanes it filled, and a while-while inner loop, nodes until a
// leaf, left lanes waiting at leaves of two rows: PERF.md). A ray's
// operations are walk_tree's and sweep_rows', in the same order (slab
// test against t_best, rows in leaf order, strict <), and the winner's u
// and v are those of its winning test: the hitdata are the one-thread-a-
// ray walk's, bit for bit. Every decision about the loop is a warp vote,
// so the warp's lanes stay together until its last ray is written.
__global__ void __launch_bounds__(kThreads, kWalkBlocks)
bounce_walk_kernel(const Tree g, const float* __restrict__ st,
                   float* __restrict__ hd, int N, int n, int* next) {
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float ix = 0.f, iy = 0.f, iz = 0.f, tb = kBig, ub = 0.f, vb = 0.f;
  int ptr = 0, end = 0, row = -1, lane = 0;
  bool walking = false, fetch = true;   // fetch: the counter may hold lanes
  ORION_BC(unsigned steps = 0, tests = 0;)
  do {
    if (fetch && __popc(__ballot_sync(kFull, walking)) < kWalkRefill) {
      if (!walking) {
        lane = take_lane(next);
        if (lane < n) {
          if (st[9 * N + lane] > 0.0f) {
            r = lane_ray(st, N, lane);
            ix = 1.0f / r.dx; iy = 1.0f / r.dy; iz = 1.0f / r.dz;
            ptr = g.first(r);
            end = ptr + g.M;
            tb = kBig;
            row = -1;
            walking = true;
            ORION_BC(steps = tests = 0;)
          } else {
            write_hit(hd, n, lane, kBig, 0.f, 0.f, -1);
          }
        }
      }
      // consecutive lanes: once one lane ran past n, so will every take
      fetch = __ballot_sync(kFull, !walking && lane >= n) == 0;
    }
    if (walking) {
#pragma unroll 1
      for (int s = 0; ptr < end && s < kWalkSteps; ++s) {
        ORION_BC(bc_vote(kBcWalkIters, kBcWalkIterLanes); ++steps;)
        const float4 n0 = __ldg(g.nodes + 2 * ptr);
        const float4 n1 = __ldg(g.nodes + 2 * ptr + 1);
        const bool hit = slab_hit(n0, n1, r, ix, iy, iz, tb);
        const int start = __float_as_int(n1.w);
        ptr = (hit && start < 0) ? ptr + 1 : __float_as_int(n1.z);
        if (hit && start >= 0) {
          ORION_BC(tests += g.leaf_width;)
          const int lo = start & ~1;
          for (int k = lo; k < lo + g.leaf_width; ++k) {
            float u, v;
            const float* w = g.tab + k * kCols;
            const float t = woop<true, true>(w, r, &u, &v);
            if (t < tb) {   // strict: the smallest row, the earlier leaf
              tb = t;
              row = k;
              ub = u;
              vb = v;
            }
          }
        }
      }
      if (ptr >= end) {
        write_hit(hd, n, lane, tb, ub, vb, row);
        walking = false;
        ORION_BC(bc_add(kBcWalkRays, 1ull); bc_add(kBcWalkSteps, steps);
                 bc_add(kBcWalkTests, tests);)
      }
    }
  } while (fetch || __any_sync(kFull, walking));
  ORION_BC(bc_warp_once(kBcWalkWarps);)
}

// Resident blocks an SM that the vis kernel (6b) is built for
// (__launch_bounds__), the walking lanes below which a warp refills, and
// the node steps a walking pair takes between two refill votes: 6a's
// loop, measured on the H100 for 6b's pairs (PERF.md; tools/bounce_probe.py
// --vis --sweep builds copies with other values).
constexpr int kVisBlocks = 8;
constexpr int kVisRefill = 16;
constexpr int kVisSteps = 32;

// one lane's visibility column: the two samples' 0/1 flags, six zeros
__device__ __forceinline__ void write_vis(float* vis, int n, int i, bool v0,
                                          bool v1) {
  vis[i] = v0 ? 1.0f : 0.0f;
  vis[n + i] = v1 ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 2; k < 8; ++k) vis[k * n + i] = 0.0f;
}

// Kernel 6b: both light samples' visibility of the single emitter, the
// shade kernel's draws and pair walk (`light_draw`, `shadow_em2`) run
// standalone, persistent and refilled as 6a is (after Aila & Laine, HPG
// 2009). The grid is as many blocks as stay resident; an idle thread
// takes lanes of the prefix from the counter *next (zero at launch;
// take_lane: one atomic for the lanes that take together, consecutive
// lanes) until one needs a walk: a lane that missed or needs neither
// sample writes its zeros at once. A warp refills when fewer than
// kVisRefill of its lanes walk; between two votes a walking lane takes up
// to kVisSteps node steps of its pair, carrying both rays, their inverse
// directions, two (t_best, emitter flag) pairs and its pointer. A pair's
// operations are shadow_em2's in the same order (a node entered when
// either ray's live segment slab-hits it, the leaf's rows in order,
// strict <, bit 0 of a leaf's start: no emitter rows), with float4 row
// loads (woop<true, true>, whose t is the scalar loads' bit for bit), so
// the planes are the one-thread-a-lane kernel's.
__global__ void __launch_bounds__(kThreads, kVisBlocks)
bounce_vis_kernel(const BounceParams p, const float* __restrict__ st,
                  const float* __restrict__ hd, float* __restrict__ vis,
                  int* next) {
  const Tree& g = p.geo;
  const float mesh = __ldg(p.em);
  Ray r0{0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, r1 = r0;
  float ix0 = 0.f, iy0 = 0.f, iz0 = 0.f, ix1 = 0.f, iy1 = 0.f, iz1 = 0.f;
  float tb0 = -kBig, tb1 = -kBig;
  bool need0 = false, need1 = false, em0 = false, em1 = false;
  int ptr = 0, end = 0, lane = 0;
  bool walking = false, fetch = true;   // fetch: the counter may hold lanes
  ORION_BC(unsigned steps = 0, tests = 0;)
  do {
    if (fetch && __popc(__ballot_sync(kFull, walking)) < kVisRefill) {
      while (!walking) {
        lane = take_lane(next);
        if (lane >= p.n) break;
        const Ray r = lane_ray(st, p.N, lane);
        const Frame f = hit_frame(p, hd, lane, r);
        if (f.hit) {
          const uint32_t upix = static_cast<uint32_t>(
              static_cast<int>(st[14 * p.N + lane]));
          const uint32_t site_sd =
              static_cast<uint32_t>(static_cast<int>(st[15 * p.N + lane])) *
                  131071u +
              static_cast<uint32_t>(p.depth);
          const LightDraw d0 =
              light_draw(p.em, 0, upix, site_sd, p.seed, 0.5f, f);
          const LightDraw d1 =
              light_draw(p.em, 1, upix, site_sd, p.seed, 0.5f, f);
          if (d0.need || d1.need) {
            r0.ox = r1.ox = f.hx + kBias * f.gnx;
            r0.oy = r1.oy = f.hy + kBias * f.gny;
            r0.oz = r1.oz = f.hz + kBias * f.gnz;
            r0.dx = d0.sdx; r0.dy = d0.sdy; r0.dz = d0.sdz;
            r1.dx = d1.sdx; r1.dy = d1.sdy; r1.dz = d1.sdz;
            need0 = d0.need;
            need1 = d1.need;
            tb0 = need0 ? kNeeTCap : -kBig;
            tb1 = need1 ? kNeeTCap : -kBig;
            em0 = em1 = false;
            ix0 = 1.0f / r0.dx; iy0 = 1.0f / r0.dy; iz0 = 1.0f / r0.dz;
            ix1 = 1.0f / r1.dx; iy1 = 1.0f / r1.dy; iz1 = 1.0f / r1.dz;
            ptr = g.first(r0);   // r0's octant's copy serves both rays
            end = ptr + g.M;
            walking = true;
            ORION_BC(bc_add(kBcShadowRays, 1ull); steps = tests = 0;)
          }
        }
        if (!walking) write_vis(vis, p.n, lane, false, false);
      }
      // consecutive lanes: once one lane ran past n, so will every take
      fetch = __ballot_sync(kFull, !walking && lane >= p.n) == 0;
    }
    if (walking) {
      ORION_BC(bc_vote(kBcShadowEntries, kBcShadowEntryLanes);)
#pragma unroll 1
      for (int s = 0; ptr < end && s < kVisSteps; ++s) {
        ORION_BC(bc_vote(kBcShadowIters, kBcShadowIterLanes); ++steps;)
        const float4 n0 = __ldg(g.nodes + 2 * ptr);
        const float4 n1 = __ldg(g.nodes + 2 * ptr + 1);
        const bool hit = slab_hit(n0, n1, r0, ix0, iy0, iz0, tb0) ||
                         slab_hit(n0, n1, r1, ix1, iy1, iz1, tb1);
        const int start = __float_as_int(n1.w);
        if (hit && start >= 0) {
          const int lo = start & ~1;
          const bool no_em = (start & 1) != 0;
          for (int k = lo; k < lo + g.leaf_width; ++k) {
            const float* w = g.tab + k * kCols;
            ORION_BC(tests += (need0 ? 1u : 0u) + (need1 ? 1u : 0u);)
            if (need0) {
              const float t = woop<true, true>(w, r0);
              if (t < tb0) {   // strict: the smallest row, the earlier leaf
                tb0 = t;
                em0 = !no_em && __ldg(w + C_MESH) == mesh;
              }
            }
            if (need1) {
              const float t = woop<true, true>(w, r1);
              if (t < tb1) {
                tb1 = t;
                em1 = !no_em && __ldg(w + C_MESH) == mesh;
              }
            }
          }
        }
        ptr = (hit && start < 0) ? ptr + 1 : __float_as_int(n1.z);
      }
      if (ptr >= end) {
        write_vis(vis, p.n, lane, need0 && em0, need1 && em1);
        walking = false;
        ORION_BC(bc_add(kBcShadowSteps, steps);
                 bc_add(kBcShadowTests, tests);)
      }
    }
  } while (fetch || __any_sync(kFull, walking));
}

// The draw-only mode of the vis kernel: the shade kernel's shadow rays of
// every (emitter, light sample) site, walked by nobody here, for a sweep
// that answers visibility elsewhere (the binned renderer, ops/binned.py).
// out [3 + 4 * sites, n]: rows 0-2 the shadow origin, then per site its
// direction (the sampled light point at t == 1) and its need flag; zeros
// where the lane missed. The draws are light_draw's, the floats the shade
// kernel computes for the same lane.
__global__ void __launch_bounds__(kThreads)
bounce_draw_kernel(const BounceParams p, const float* __restrict__ st,
                   const float* __restrict__ hd, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int n = p.n, sites = p.n_em * p.light_samples;
  const Ray r = lane_ray(st, p.N, i);
  const Frame f = hit_frame(p, hd, i, r);
  if (!f.hit) {
    for (int k = 0; k < 3 + 4 * sites; ++k) out[k * n + i] = 0.0f;
    return;
  }
  const uint32_t upix = static_cast<uint32_t>(
      static_cast<int>(st[14 * p.N + i]));
  const uint32_t site_sd =
      static_cast<uint32_t>(static_cast<int>(st[15 * p.N + i])) * 131071u +
      static_cast<uint32_t>(p.depth);
  out[i] = f.hx + kBias * f.gnx;
  out[n + i] = f.hy + kBias * f.gny;
  out[2 * n + i] = f.hz + kBias * f.gnz;
  const float inv_ls = static_cast<float>(1.0 / p.light_samples);
  for (int mi = 0; mi < p.n_em; ++mi) {
    for (int ls = 0; ls < p.light_samples; ++ls) {
      const int site = ls + p.light_samples * mi;
      const LightDraw dl = light_draw(p.em + mi * kEmStride, site, upix,
                                      site_sd, p.seed, inv_ls, f);
      float* o = out + (3 + 4 * site) * n + i;
      o[0] = dl.sdx;
      o[n] = dl.sdy;
      o[2 * n] = dl.sdz;
      o[3 * n] = dl.need ? 1.0f : 0.0f;
    }
  }
}

__device__ __forceinline__ int spread_bits(int q, int shift) {
  int out = 0;
#pragma unroll
  for (int b = 0; b < kMortonBits; ++b) out |= ((q >> b) & 1) << (3 * b + shift);
  return out;
}

// dead-last | direction octant | origin morton (ops/reorder.py's key)
__device__ __forceinline__ float sort_key(const BounceParams& p, const Ray& r,
                                          bool alive) {
  if (!alive) return static_cast<float>(kDeadKey);
  const int octant = (r.dx >= 0.0f ? 1 : 0) + (r.dy >= 0.0f ? 2 : 0) +
                     (r.dz >= 0.0f ? 4 : 0);
  const float o[3] = {r.ox, r.oy, r.oz};
  int morton = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    int q = __float2int_rz(__fmul_rn(__fsub_rn(o[a], p.lo[a]), p.scale[a]));
    q = max(0, min(q, (1 << kMortonBits) - 1));
    morton |= spread_bits(q, a);
  }
  return static_cast<float>((octant << (3 * kMortonBits)) | morton);
}

// The resident blocks an SM that the shade kernel (6c) is built for
// (__launch_bounds__), measured on the H100 as kWalkBlocks was.
constexpr int kShadeBlocks = 10;

// Kernel 6c: a thread shades one lane: its frame, then fast-shadow NEE
// (one walk for both light samples of an emitter, or the visibility planes
// when given, kVis), the roulette, the bounce and the writes.
template <bool kAux, bool kVis>
__global__ void __launch_bounds__(kThreads, kShadeBlocks)
bounce_shade_kernel(const BounceParams p, float* __restrict__ st,
                    const float* __restrict__ hd,
                    const float* __restrict__ kdp,
                    const float* __restrict__ visp, float* __restrict__ aux) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int N = p.N, n = p.n;
  ORION_BC(const long long c_start = clock64(); long long c_draw = 0,
           c_shadow = 0; bc_add(kBcShadeLanes, 1ull);
           bc_warp_once(kBcShadeWarps);)
  Ray r = lane_ray(st, N, i);
  const Frame f = hit_frame(p, hd, i, r);
  ORION_BC(c_draw += clock64() - c_start;)
  float T[3] = {st[6 * N + i], st[7 * N + i], st[8 * N + i]};
  float kd[3] = {0.f, 0.f, 0.f}, A[3] = {0.f, 0.f, 0.f};
  float rad[3] = {0.f, 0.f, 0.f};
  float em_scale = 0.f, sum_scale = 0.f, mesh = 0.f, inv_p = 0.f;
  bool cont = false;
  if (f.hit) {
    const float* g = f.g;
    const uint32_t upix = static_cast<uint32_t>(
        static_cast<int>(st[14 * N + i]));
    const uint32_t site_sd =
        static_cast<uint32_t>(static_cast<int>(st[15 * N + i])) * 131071u +
        static_cast<uint32_t>(p.depth);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      kd[ch] = kdp ? kdp[ch * n + i] : __ldg(g + C_KD + ch);
    const float ke[3] = {__ldg(g + C_KE), __ldg(g + C_KE + 1),
                         __ldg(g + C_KE + 2)};
    mesh = __ldg(g + C_MESH);

    // depth-0 emissive term: Ke * meshArea * dot(norm(d), -s_n)
    if (p.depth == 0) {
      float ndx = r.dx, ndy = r.dy, ndz = r.dz;
      norm3(ndx, ndy, ndz);
      const float cosv = -(ndx * f.snx + ndy * f.sny + ndz * f.snz);
      em_scale = __ldg(g + C_AREA) * cosv;
    }

    // fast-shadow next-event estimation
    const float inv_ls = static_cast<float>(1.0 / p.light_samples);
    Ray s0;
    s0.ox = f.hx + kBias * f.gnx;
    s0.oy = f.hy + kBias * f.gny;
    s0.oz = f.hz + kBias * f.gnz;
    for (int mi = 0; mi < p.n_em; ++mi) {
      const float* E = p.em + mi * kEmStride;
      const float em_mesh = __ldg(E);
      const float ske[3] = {__ldg(E + 2), __ldg(E + 3), __ldg(E + 4)};
      if (p.light_samples == 2) {
        // both samples behind one walk
        ORION_BC(const long long c1 = clock64();)
        const LightDraw d0 = light_draw(E, 2 * mi, upix, site_sd, p.seed,
                                        inv_ls, f);
        const LightDraw d1 = light_draw(E, 2 * mi + 1, upix, site_sd, p.seed,
                                        inv_ls, f);
        ORION_BC(c_draw += clock64() - c1;)
        bool v0 = false, v1 = false;
        if (kVis) {   // one plane per site: ls + light_samples * mi
          v0 = visp[(2 * mi) * n + i] > 0.0f;
          v1 = visp[(2 * mi + 1) * n + i] > 0.0f;
        } else if (d0.need || d1.need) {
          Ray s1 = s0;
          s0.dx = d0.sdx; s0.dy = d0.sdy; s0.dz = d0.sdz;
          s1.dx = d1.sdx; s1.dy = d1.sdy; s1.dz = d1.sdz;
          ORION_BC(const long long c2 = clock64();)
          shadow_em2(p.geo, s0, s1, d0.need, d1.need, em_mesh, v0, v1);
          ORION_BC(c_shadow += clock64() - c2;)
        }
        const float sc0 = v0 ? d0.scale : 0.0f, sc1 = v1 ? d1.scale : 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          A[ch] = __fadd_rn(A[ch], __fmul_rn(ske[ch], sc0));
          A[ch] = __fadd_rn(A[ch], __fmul_rn(ske[ch], sc1));
        }
        sum_scale = __fadd_rn(__fadd_rn(sum_scale, sc0), sc1);
      } else {
        for (int ls = 0; ls < p.light_samples; ++ls) {
          const LightDraw dl = light_draw(E, ls + p.light_samples * mi, upix,
                                          site_sd, p.seed, inv_ls, f);
          if (!dl.need) continue;
          if (kVis) {
            if (!(visp[(ls + p.light_samples * mi) * n + i] > 0.0f)) continue;
          } else {
            s0.dx = dl.sdx; s0.dy = dl.sdy; s0.dz = dl.sdz;
            if (!shadow_em(p.geo, s0, em_mesh)) continue;
          }
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            A[ch] = __fadd_rn(A[ch], __fmul_rn(ske[ch], dl.scale));
          sum_scale = __fadd_rn(sum_scale, dl.scale);
        }
      }
    }
    bounce_contrib(T, ke, em_scale, kd, A, rad);

    // Russian roulette + cosine bounce
    uint32_t a = upix, b = site_sd, c = 0x5EEDu, d = p.seed;
    pcg4d(a, b, c, d);
    const float u_rr = u01(a), u1 = u01(b), u2 = u01(c);
    const float p_cont = fmaxf(fmaxf(kd[0], kd[1]), kd[2]);
    inv_p = p_cont > 0.0f ? 1.0f / p_cont : 0.0f;
    cont = p.depth < p.max_depth && u_rr <= p_cont;
    if (cont) {
      const float sin_th = sqrtf(u1);
      const float cos_th = sqrtf(fmaxf(1.0f - u1, 0.0f));
      float t1x = f.snz, t1y = 0.0f, t1z = -f.snx;
      if (t1x * t1x + t1z * t1z == 0.0f) {
        t1x = -f.sny;
        t1y = f.snx;
      }
      norm3(t1x, t1y, t1z);
      const float btx = f.sny * t1z - f.snz * t1y;
      const float bty = f.snz * t1x - f.snx * t1z;
      const float btz = f.snx * t1y - f.sny * t1x;
      // sin and cos of psi = 2 pi u2, argument reduced exactly (no slow
      // path to call, so no stack frame for it)
      float sin_psi, cos_psi;
      sincospif(2.0f * u2, &sin_psi, &cos_psi);
      const float ca = sin_th * cos_psi;
      const float cb = sin_th * sin_psi;
      r.dx = ca * t1x + cb * btx + cos_th * f.snx;
      r.dy = ca * t1y + cb * bty + cos_th * f.sny;
      r.dz = ca * t1z + cb * btz + cos_th * f.snz;
      r.ox = f.hx + f.snx * kBias;
      r.oy = f.hy + f.sny * kBias;
      r.oz = f.hz + f.snz * kBias;
      st[i] = r.ox; st[N + i] = r.oy; st[2 * N + i] = r.oz;
      st[3 * N + i] = r.dx; st[4 * N + i] = r.dy; st[5 * N + i] = r.dz;
    }
  }
  const float contf = cont ? 1.0f : 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    st[(6 + ch) * N + i] =
        __fmul_rn(__fmul_rn(__fmul_rn(T[ch], kd[ch]), inv_p), contf);
    st[(10 + ch) * N + i] = __fadd_rn(st[(10 + ch) * N + i], rad[ch]);
  }
  st[9 * N + i] = contf;
  st[13 * N + i] = sort_key(p, r, cont);
  if (kAux) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      aux[ch * n + i] = kd[ch];
      aux[(3 + ch) * n + i] = A[ch];
      aux[(6 + ch) * n + i] = rad[ch];
    }
    aux[9 * n + i] = em_scale;
    aux[10 * n + i] = sum_scale;
    aux[11 * n + i] = mesh;
    aux[12 * n + i] = f.hit ? 1.0f : 0.0f;
    aux[13 * n + i] = contf;
    aux[14 * n + i] = inv_p;
    aux[15 * n + i] = 0.0f;
  }
  ORION_BC(bc_add(kBcShadeCycles, clock64() - c_start);
           bc_add(kBcDrawCycles, c_draw); bc_add(kBcShadowCycles, c_shadow);)
}

BounceParams make_params(const float* nodes, const float* tab,
                         const float* em, int M, int leaf_width, int copies,
                         int B_pad, int n_em, int N, int n, int seed,
                         int depth, int max_depth, int light_samples) {
  BounceParams p;
  p.geo = Tree{reinterpret_cast<const float4*>(nodes), tab, M, leaf_width,
               copies};
  p.em = em;
  p.n_em = n_em;
  p.light_samples = light_samples;
  p.B_pad = B_pad;
  p.N = N;
  p.n = n;
  p.depth = depth;
  p.max_depth = max_depth;
  p.seed = static_cast<uint32_t>(seed);
  for (int a = 0; a < 3; ++a) {
    p.lo[a] = 0.0f;
    p.scale[a] = 0.0f;
  }
  return p;
}

inline int grid_of(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// `next`: one int32, zero, the persistent lanes' counter
extern "C" int bounce_walk_launch(const float* nodes, const float* tab,
                                  const float* st, float* hd, int* next,
                                  int M, int leaf_width, int copies, int N,
                                  int n, void* stream) {
  if (n > 0) {
    const Tree g{reinterpret_cast<const float4*>(nodes), tab, M, leaf_width,
                 copies};
    bounce_walk_kernel<<<persistent_blocks(bounce_walk_kernel, 0, n),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        g, st, hd, N, n, next);
  }
  return static_cast<int>(cudaGetLastError());
}

// draws == 0: the standalone visibility planes of one emitter's two light
// samples ([8, n]); draws != 0: the shadow rays of every site of n_em
// emitters x light_samples ([3 + 4 * sites, n]).
// `next`: one int32, zero, the vis kernel's lane counter (the draws leave
// it alone)
extern "C" int bounce_vis_launch(const float* nodes, const float* tab,
                                 const float* em, const float* st,
                                 const float* hd, float* vis, int* next,
                                 int M, int leaf_width, int copies, int B_pad,
                                 int n_em, int N, int n, int seed, int depth,
                                 int light_samples, int draws, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (draws) {
      const BounceParams p = make_params(nodes, tab, em, M, leaf_width,
                                         copies, B_pad, n_em, N, n, seed,
                                         depth, 0, light_samples);
      bounce_draw_kernel<<<grid_of(n), kThreads, 0, s>>>(p, st, hd, vis);
    } else {
      const BounceParams p = make_params(nodes, tab, em, M, leaf_width,
                                         copies, B_pad, 1, N, n, seed, depth,
                                         0, 2);
      bounce_vis_kernel<<<persistent_blocks(bounce_vis_kernel, 0, n),
                          kThreads, 0, s>>>(p, st, hd, vis, next);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bounce_shade_launch(const float* nodes, const float* tab,
                                   const float* em, float* st,
                                   const float* hd, const float* kd,
                                   const float* vis, float* aux, float lo_x,
                                   float lo_y, float lo_z, float sc_x,
                                   float sc_y, float sc_z, int M,
                                   int leaf_width, int copies, int B_pad,
                                   int n_em, int N, int n, int seed, int depth,
                                   int max_depth, int light_samples,
                                   void* stream) {
  if (n > 0) {
    BounceParams p = make_params(nodes, tab, em, M, leaf_width, copies, B_pad,
                                 n_em, N, n, seed, depth, max_depth,
                                 light_samples);
    p.lo[0] = lo_x; p.lo[1] = lo_y; p.lo[2] = lo_z;
    p.scale[0] = sc_x; p.scale[1] = sc_y; p.scale[2] = sc_z;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = grid_of(n);
    if (aux && vis)
      bounce_shade_kernel<true, true><<<grid, kThreads, 0, s>>>(p, st, hd, kd,
                                                                vis, aux);
    else if (aux)
      bounce_shade_kernel<true, false><<<grid, kThreads, 0, s>>>(p, st, hd, kd,
                                                                 vis, aux);
    else if (vis)
      bounce_shade_kernel<false, true><<<grid, kThreads, 0, s>>>(p, st, hd, kd,
                                                                 vis, aux);
    else
      bounce_shade_kernel<false, false><<<grid, kThreads, 0, s>>>(p, st, hd,
                                                                  kd, vis, aux);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = render_lane.cuh's kernel_info of the walk kernel (which 0), the
// shade kernel <kAux, kVis> (which 1 + 2 kAux + kVis), the vis kernel (5)
// or the draw kernel (6)
extern "C" int bounce_info(int which, int* out) {
  switch (which) {
    case 0: return kernel_info(bounce_walk_kernel, 0, out);
    case 1: return kernel_info(bounce_shade_kernel<false, false>, 0, out);
    case 2: return kernel_info(bounce_shade_kernel<false, true>, 0, out);
    case 3: return kernel_info(bounce_shade_kernel<true, false>, 0, out);
    case 4: return kernel_info(bounce_shade_kernel<true, true>, 0, out);
    case 5: return kernel_info(bounce_vis_kernel, 0, out);
    case 6: return kernel_info(bounce_draw_kernel, 0, out);
    default: return -1;
  }
}

#ifdef ORION_BOUNCE_COUNTERS
extern "C" int bounce_counters_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_bounce_counters,
                                               sizeof(g_bounce_counters)));
}
extern "C" int bounce_counters_reset() {
  const unsigned long long zero[kBcCount] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_bounce_counters, zero, sizeof(zero)));
}
#endif
