// Grouped-pointer BVH walk (G8): nearest hit, or any hit, of rays against
// a flattened tree of 128-row leaves, one node pointer per group of lanes.
//
// Replaces: orion_tpu/ops/pallas_bvh_g8.py::_make_kernel(M, any_hit)
// (launched by _traverse_g8_impl), the JAX package's grouped-pointer
// redesign of the block-uniform walk, kept there as a measured negative
// result and reached by name (make_bvh_intersect_g8).
//
// Contract: kernel 5's (bvh_intersect.cu). Nodes [M, 8] (lo xyz, hi xyz,
// skip, start as int32 bits), leaves of 128 rows of the [B_pad, 16] Woop
// table. Nearest: (t, row) of the winner (min t, ties to the smallest row
// within a leaf, the earlier leaf across leaves), or (+inf, -1); any hit:
// (1.0, the nearest row of the first leaf with a hit) or (+inf, -1); a
// dead lane (alive == 0) reports a miss.
//
// Scheduling, the only thing that differs from kernel 5: a warp of 32
// lanes shares ONE node pointer and walks the union of its lanes' paths
// (the TPU kernel gives each 128-lane group of its 1,024-ray block one
// pointer). Each lane walks exactly its own path inside that union: where
// its slab test of node p fails, it records p's skip pointer as `resume`
// and ignores the nodes the warp visits below it (the skip-pointer layout
// puts p's subtree in [p, skip[p]), and the warp's pointer lands on
// skip[p] once it leaves that subtree). So a lane makes the plain walk's
// slab tests, on the plain walk's nodes, in its order, and its (t, row)
// are bvh_walk_plain's bit for bit (the slab arithmetic has no
// multiply-add to contract; the Woop test is woop_t_rn, explicit
// round-to-nearest, as kernel 5's). The warp descends where any lane's own
// test passes (__ballot_sync) and otherwise jumps to the node's skip.
//
// At a leaf only the lanes whose own test passed take part, and the warp
// serves them one at a time: each of the 32 threads holds 4 of the leaf's
// 128 rows (rows j, j + 32, j + 64, j + 96 of thread j, loaded once a leaf
// as float4), tests them against the served lane's ray (broadcast by
// __shfl_sync) keeping the strictly smaller t below that lane's best, and
// a butterfly of __shfl_xor_sync merges the 32 bests by the least (t,
// row), as kernel 2 merges its split rows: the smallest row among the
// least t, which a sequential sweep of the leaf keeps too. Any hit: a
// lane settles at its first leaf with a hit (resume = M), and where no
// lane needs the rest of the tree the warp's pointer jumps to the least
// `resume` of its lanes (past M: the warp is done).
//
// Only live rays hold lanes: a block first lists its kBlockRays rays' live
// ones in order in shared memory (a ballot a warp and a prefix over the
// warps), answers the dead ones at once, and its warps walk the list in
// groups. Where the launch's blocks fit one wave of the card (a 256x256
// wavefront's sweeps), a launch lasts as long as its slowest group, so
// the list is spread evenly over the block's 4 warps (groups of up to 32,
// walked side by side); past one wave (a 1080p sweep, a bounce
// wavefront) groups are packed full, which makes the fewest node steps.
//
// What bounds it on the H100: operations and latency, as kernel 5. The
// union walk trades divergence (a warp of kernel 5 waits for its longest
// lane) for node steps that only some of its lanes need; a leaf costs a
// lane that needs it 4 Woop tests a thread and a 5-step merge, where the
// first port had every lane test all 128 rows.

#include "render_lane.cuh"

namespace {

using orion::kBig;
using orion::kThreads;

constexpr int kLeaf = 128;                 // rows per leaf
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = kLeaf / 32;
constexpr unsigned kAll = 0xffffffffu;

// Resident blocks an SM the walk is built for (__launch_bounds__) and the
// consecutive rays a block compacts (a multiple of kThreads). Measured on
// the H100 (PERF.md; tools/bvh_probe.py --g8 --sweep builds copies with
// other values).
constexpr int kG8Blocks = 6;
constexpr int kBlockRays = 128;

// Instrumented build (-DORION_G8_COUNTERS, made by tools/bvh_probe.py
// --g8, never by ops/cuda_build.py): the lowest lane of a warp adds, for
// each group of rays the warp walks behind one pointer, its live lanes,
// the pointer's node steps and the leaves it opens, the lanes whose own
// slab test passed at each such leaf, the Woop tests the warp's threads
// run, and the group's clock64() cycles in all and in leaves. Read and
// cleared by g8_counters_read / g8_counters_reset (extern "C", below).
#ifdef ORION_G8_COUNTERS
enum G8Counter {
  kGcGroups,      // groups walked (a warp's live rays behind one pointer)
  kGcLiveLanes,   // live lanes summed over groups
  kGcSteps,       // node steps of the shared pointer
  kGcLeaves,      // leaves opened
  kGcLeafLanes,   // lanes whose own slab test passed, over those leaves
  kGcRowTests,    // Woop tests run by the warp's threads
  kGcCycles,      // a group's cycles from its start to its end
  kGcLeafCycles,  // of those, in leaves
  kGcCount
};
__device__ unsigned long long g_g8_counters[kGcCount];

__device__ __forceinline__ void gc_add(int k, unsigned long long v) {
  atomicAdd(g_g8_counters + k, v);
}
#define ORION_GC(...) __VA_ARGS__
#else
#define ORION_GC(...)
#endif

// One group: lane `lane` walks ray `ray` (-1: no ray) behind the warp's
// shared pointer and writes its (t, row).
template <bool kAnyHit>
__device__ __forceinline__ void walk_group(
    int ray, const float* __restrict__ orig, const float* __restrict__ dirs,
    const float4* __restrict__ nodes, const float4* __restrict__ tri, int M,
    float* __restrict__ t_out, int* __restrict__ row_out) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  if (ray >= 0) {
    ox = orig[3 * ray]; oy = orig[3 * ray + 1]; oz = orig[3 * ray + 2];
    dx = dirs[3 * ray]; dy = dirs[3 * ray + 1]; dz = dirs[3 * ray + 2];
  }
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float tb = kBig;
  int rb = -1;
  // the lane takes part at the nodes from `resume` on (M: at none)
  int resume = ray >= 0 ? 0 : M;
  int ptr = 0;   // warp-uniform
  ORION_GC(const long long c0 = clock64(); long long c_leaf = 0;
           unsigned long long steps = 0, leaves = 0, leaf_lanes = 0,
           tests = 0;)
  while (ptr < M) {
    ORION_GC(++steps;)
    const float4 n0 = __ldg(nodes + 2 * ptr);      // lo.xyz, hi.x
    const float4 n1 = __ldg(nodes + 2 * ptr + 1);  // hi.yz, skip, start
    const int skip = __float_as_int(n1.z), start = __float_as_int(n1.w);
    bool pass = false;
    if (resume <= ptr) {
      const float tx0 = (n0.x - ox) * ix, tx1 = (n0.w - ox) * ix;
      const float ty0 = (n0.y - oy) * iy, ty1 = (n1.x - oy) * iy;
      const float tz0 = (n0.z - oz) * iz, tz1 = (n1.y - oz) * iz;
      const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                               fminf(tz0, tz1));
      const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                               fmaxf(tz0, tz1));
      pass = (tmax >= tmin) && (tmax > 0.0f) && (tmin < tb);
      if (!pass) resume = skip;   // the lane's own walk goes on there
    }
    const unsigned need = __ballot_sync(kAll, pass);
    if (start < 0) {
      ptr = need ? ptr + 1 : skip;
      continue;
    }
    if (need) {
      ORION_GC(const long long c1 = clock64(); ++leaves;
               leaf_lanes += __popc(need);)
      // this thread's rows, held while the warp serves the needing lanes
      // (loading them again for each lane was slower: PERF.md)
      float4 ra[kRowsPerThread], rbv[kRowsPerThread], rc[kRowsPerThread];
      float re[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const float4* w = tri + 4 * (start + lane + 32 * j);
        ra[j] = __ldg(w);
        rbv[j] = __ldg(w + 1);
        rc[j] = __ldg(w + 2);
        re[j] = __ldg(reinterpret_cast<const float*>(w + 3));
      }
      unsigned m = need;
      while (m) {   // warp-uniform: serve the needing lanes in turn
        ORION_GC(tests += 32ull * kRowsPerThread;)
        const int src = __ffs(m) - 1;
        m &= m - 1u;
        const float sox = __shfl_sync(kAll, ox, src);
        const float soy = __shfl_sync(kAll, oy, src);
        const float soz = __shfl_sync(kAll, oz, src);
        const float sdx = __shfl_sync(kAll, dx, src);
        const float sdy = __shfl_sync(kAll, dy, src);
        const float sdz = __shfl_sync(kAll, dz, src);
        float bt = __shfl_sync(kAll, tb, src);
        int br = -1;   // -1: nothing below the lane's best
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const float t = orion::woop_t_rn(
              ra[j], rbv[j], rc[j], make_float4(re[j], 0.f, 0.f, 0.f), sox,
              soy, soz, sdx, sdy, sdz);
          if (t < bt) {   // strict: this thread's smallest row
            bt = t;
            br = start + lane + 32 * j;
          }
        }
        // the least (t, row) of the 32 threads; -1 rows sit at the lane's
        // own best, which every improving t is below
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ot = __shfl_xor_sync(kAll, bt, o);
          const int orow = __shfl_xor_sync(kAll, br, o);
          if (ot < bt || (ot == bt && orow < br)) {
            bt = ot;
            br = orow;
          }
        }
        if (lane == src && br >= 0) {
          tb = bt;
          rb = br;
        }
      }
      ORION_GC(c_leaf += clock64() - c1;)
    }
    ptr = skip;
    if (kAnyHit) {
      if (rb >= 0) resume = M;   // settled at its first leaf with a hit
      // no lane needs the nodes up to the least resume: go there
      if (!__any_sync(kAll, resume <= ptr))
        ptr = __reduce_min_sync(kAll, resume);
    }
  }
  ORION_GC(const unsigned live_m = __ballot_sync(kAll, ray >= 0);
           if (lane == 0) {
             gc_add(kGcGroups, 1ull);
             gc_add(kGcLiveLanes, __popc(live_m));
             gc_add(kGcSteps, steps);
             gc_add(kGcLeaves, leaves);
             gc_add(kGcLeafLanes, leaf_lanes);
             gc_add(kGcRowTests, tests);
             gc_add(kGcCycles, clock64() - c0);
             gc_add(kGcLeafCycles, c_leaf);
           })
  if (ray >= 0) {
    row_out[ray] = rb;
    t_out[ray] = rb < 0 ? __int_as_float(0x7f800000)  // +inf
                        : (kAnyHit ? 1.0f : tb);
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kG8Blocks)
bvh_g8_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
              const uint8_t* __restrict__ alive,
              const float4* __restrict__ nodes, const float4* __restrict__ tri,
              int M, int N, int spread, float* __restrict__ t_out,
              int* __restrict__ row_out) {
  static_assert(kBlockRays % kThreads == 0, "kBlockRays: whole blocks");
  constexpr int kPasses = kBlockRays / kThreads;
  constexpr int kSegs = kPasses * kWarps;   // (pass, warp) in ray order
  __shared__ int live[kBlockRays];
  __shared__ int counts[kSegs];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31, warp = tid >> 5;
  const int base = static_cast<int>(blockIdx.x) * kBlockRays;

  // the block's live rays in order: a ballot a warp and pass, then each
  // live ray's place after the live rays of the (pass, warp)s before it
  unsigned bal[kPasses];
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int i = base + k * kThreads + tid;
    const bool in = i < N;
    const bool a = in && alive[i] != 0;
    if (in && !a) {
      t_out[i] = __int_as_float(0x7f800000);  // +inf
      row_out[i] = -1;
    }
    bal[k] = __ballot_sync(kAll, a);
    if (lane == 0) counts[k * kWarps + warp] = __popc(bal[k]);
  }
  __syncthreads();
  int n_live = 0;
  int before[kPasses];
#pragma unroll
  for (int k = 0; k < kPasses; ++k) before[k] = 0;
  for (int s = 0; s < kSegs; ++s) {
    const int c = counts[s];
#pragma unroll
    for (int k = 0; k < kPasses; ++k)
      before[k] += s < k * kWarps + warp ? c : 0;
    n_live += c;
  }
#pragma unroll
  for (int k = 0; k < kPasses; ++k)
    if (bal[k] & (1u << lane))
      live[before[k] + __popc(bal[k] & ((1u << lane) - 1u))] =
          base + k * kThreads + tid;
  __syncthreads();
  // a group's lanes: 32, or the list spread evenly over the warps
  const int per = spread ? min(32, (n_live + kWarps - 1) / kWarps) : 32;
  for (int g = warp * per; g < n_live; g += kWarps * per) {  // warp-uniform
    const int slot = g + lane;
    walk_group<kAnyHit>(lane < per && slot < n_live ? live[slot] : -1, orig,
                        dirs, nodes, tri, M, t_out, row_out);
  }
}

using Kernel = void (*)(const float*, const float*, const uint8_t*,
                        const float4*, const float4*, int, int, int, float*,
                        int*);

Kernel kernel_of(int any_hit) {
  return any_hit ? bvh_g8_kernel<true> : bvh_g8_kernel<false>;
}

// the resident blocks of an instantiation on the card, queried at its first
// launch (so that no occupancy query runs inside a CUDA graph's capture)
int resident_blocks(int any_hit) {
  static int blocks[2] = {0, 0};
  int& b = blocks[any_hit];
  if (b == 0) b = orion::persistent_blocks(kernel_of(any_hit), 0, 1 << 30);
  return b;
}

}  // namespace

extern "C" int bvh_g8_launch(const float* orig, const float* dirs,
                             const uint8_t* alive, const float* nodes,
                             const float* tri, int M, int N, int any_hit,
                             float* t_out, int* row_out, void* stream) {
  if (N > 0) {
    const int which = any_hit ? 1 : 0;
    const int blocks = (N + kBlockRays - 1) / kBlockRays;
    const int spread = blocks <= resident_blocks(which);
    kernel_of(which)<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        orig, dirs, alive, reinterpret_cast<const float4*>(nodes),
        reinterpret_cast<const float4*>(tri), M, N, spread, t_out, row_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = [resident blocks an SM, registers, local bytes, static shared
// bytes] of the walk as built: which = any_hit
extern "C" int bvh_g8_info(int which, int* out) {
  return orion::kernel_info(kernel_of(which), 0, out);
}

#ifdef ORION_G8_COUNTERS
extern "C" int g8_counters_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_g8_counters,
                                               sizeof(g_g8_counters)));
}
extern "C" int g8_counters_reset() {
  const unsigned long long zero[kGcCount] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_g8_counters, zero, sizeof(zero)));
}
#endif
