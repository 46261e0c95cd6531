// Skip-pointer BVH walk: nearest hit, or any hit, of rays against a
// flattened tree.
//
// Replaces: orion_tpu/ops/pallas_bvh.py::_make_kernel(M, W, any_hit)
// (launched by _traverse_pallas_impl), the wavefront renderer's intersect
// for scenes past the brute sweep's gate, and its occlusion variant for
// Whitted shadow rays.
//
// Contract. Nodes are [M, 8] rows (lo xyz, hi xyz, skip, start; the last
// two are int32 bits), node i's subtree is [i + 1, skip[i]), a leaf has
// start >= 0 and owns the `leaf_width` rows [start, start + leaf_width) of
// the [B_pad, 16] Woop table (columns 0..12; padding rows always miss).
// Per ray: ptr = 0; at each node the slab test (tmax >= tmin, so flat boxes
// hit; tmax > 0; tmin < t_best); on a hit leaf the Woop test of its rows,
// winner min t with ties to the smallest row, replacing the best only when
// strictly smaller; ptr = hit && !leaf ? ptr + 1 : skip[ptr]. Nearest: (t,
// row) of the winner, or (+inf, -1). Any hit (kAnyHit): the ray leaves the
// loop at its first hit leaf and reports (1.0, that leaf's nearest row).
// Dead rays (alive == 0) give (+inf, -1). The Python wrapper maps rows to
// scene triangle ids.
//
// The TPU kernel walks one pointer per block of rays and enters a subtree
// if any lane hits its box. A thread here walks alone, which gives the same
// winners: a lane whose own slab test fails cannot improve inside that box.
//
// What bounds it on the H100: neither its inputs' bytes nor its operations
// (its bound is a few percent of its time, PERF.md) but each ray's chain of
// dependent loads. A slab test is 12 FP32 operations (6 subtracts, 6
// multiplies; the 10 min/max and the compares are not counted, as the Woop
// test's compares are not; chip_smoke.py's SLAB_TEST_FLOPS) on one 32-byte
// node row, a Woop test 39 on a 64-byte row, and both tables stay in L2 (a
// 35k-triangle scene at leaf width 2 is about 1.2 MB of nodes and 2.3 MB
// of rows). Each node depends on the one before it (the pointer), so a ray
// is a chain of dependent loads, and a warp lasts as long as its longest
// lane's chain.
//
// Design (PERF.md, PR 11; tools/bvh_probe.py --walk measures it): two
// instantiations, and the launch picks one by the sweep's size.
//   - spread: where a thread for every ray stays resident (a 256x256
//     wavefront's sweeps of 65,536-131,072 rays fill a quarter of the
//     card), a launch is latency-bound: it lasts as long as its longest
//     warp's chain of node loads. Each thread walks its own ray through
//     windows of kSpreadWindow consecutive node rows loaded together: a
//     hit internal node steps to ptr + 1 and a leaf's skip is ptr + 1, so
//     a descent and a leaf's sibling cost no new round trip to L2 (a ray's
//     47 node visits take 30 loads); only a jump over a missed subtree
//     waits for the next load.
//   - counted: where the rays outnumber the resident threads (a 1080p
//     wavefront's 2-4M rays, of which ~70% are dead), the grid is the
//     resident blocks and each warp is persistent: it takes kChunk
//     consecutive rays with one atomic on a lane counter, answers their
//     dead rays at once, keeps their live ones as a bit queue, and hands
//     one to each idle lane (the queue's i-th live ray to the i-th idle
//     lane) when fewer than kBvhRefill lanes walk; a walking lane takes
//     kBvhSteps windows of kCountedWindow rows between two votes. The card
//     is full here, so a window's extra bytes cost more than its round
//     trips save: one row a load.
// A ray's operations are walk_tree's (fused_common.cuh) in the same order:
// the slab arithmetic has no multiply-add to contract, the Woop test is
// woop_t_rn (explicit round-to-nearest, as brute_intersect.cu), so (t, row)
// equal the plain PyTorch walk's bit for bit.

#include "render_lane.cuh"

namespace {

using orion::kBig;
using orion::kThreads;

// The spread instantiation's resident blocks an SM (__launch_bounds__) and
// window; the counted one's, the walking lanes below which a warp refills,
// the windows a walking lane takes between two votes, and the rays a warp
// takes from the counter at a time (64: two words of queue). Measured on
// the H100 (PERF.md; tools/bvh_probe.py --walk --sweep builds copies of
// this source with other values).
constexpr int kSpreadBlocks = 8;
constexpr int kSpreadWindow = 2;
constexpr int kCountedBlocks = 12;
constexpr int kCountedWindow = 1;
constexpr int kBvhRefill = 16;
constexpr int kBvhSteps = 16;
constexpr int kChunk = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Instrumented build (-DORION_WALK_COUNTERS, made by tools/bvh_probe.py,
// never by ops/cuda_build.py): rays walked, node rows tested, leaf rows
// tested and windows loaded, summed over rays; the warp iterations of the
// window loop, their active lanes, and those with fewer than half the
// warp's lanes walking (the tail); the warps; the warps' take rounds (one
// atomic on the counter each). Read and cleared by
// walk_counters_read / walk_counters_reset (extern "C", below).
#ifdef ORION_WALK_COUNTERS
enum WalkCounter {
  kWcRays,
  kWcSteps,
  kWcTests,
  kWcLoads,
  kWcIters,
  kWcIterLanes,
  kWcTailIters,
  kWcWarps,
  kWcTakes,
  kWcCount
};
__device__ unsigned long long g_walk_counters[kWcCount];

__device__ __forceinline__ void wc_add(int k, unsigned long long v) {
  atomicAdd(g_walk_counters + k, v);
}

// the lowest active lane counts one warp iteration, its active lanes and
// whether fewer than half the warp walk
__device__ __forceinline__ void wc_vote() {
  const unsigned m = __activemask();
  if ((threadIdx.x & 31) == __ffs(m) - 1) {
    wc_add(kWcIters, 1ull);
    wc_add(kWcIterLanes, __popc(m));
    if (__popc(m) < 16) wc_add(kWcTailIters, 1ull);
  }
}
// one warp event, counted by the lowest active lane
__device__ __forceinline__ void wc_warp_once(int k) {
  if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) wc_add(k, 1ull);
}
#define ORION_WC(...) __VA_ARGS__
#else
#define ORION_WC(...)
#endif

template <bool kAnyHit, bool kCounted>
__global__ void __launch_bounds__(kThreads,
                                  kCounted ? kCountedBlocks : kSpreadBlocks)
bvh_intersect_kernel(const float* __restrict__ orig,
                     const float* __restrict__ dirs,
                     const uint8_t* __restrict__ alive,
                     const float4* __restrict__ nodes,
                     const float4* __restrict__ tri, int M, int W, int N,
                     float* __restrict__ t_out, int* __restrict__ row_out,
                     int* next) {
  constexpr int kWindow = kCounted ? kCountedWindow : kSpreadWindow;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float ix = 0.f, iy = 0.f, iz = 0.f, tb = kBig;
  int ptr = M, row = -1, ray = N;
  bool walking = false;
  ORION_WC(unsigned steps = 0, tests = 0, loads = 0;)
  // ray `ray` starts walking, or a dead one is answered at once
  auto take = [&]() {
    if (ray >= N) return;
    if (alive[ray] != 0) {
      ox = orig[3 * ray]; oy = orig[3 * ray + 1]; oz = orig[3 * ray + 2];
      dx = dirs[3 * ray]; dy = dirs[3 * ray + 1]; dz = dirs[3 * ray + 2];
      ix = 1.0f / dx; iy = 1.0f / dy; iz = 1.0f / dz;
      ptr = 0;
      tb = kBig;
      row = -1;
      walking = true;
      ORION_WC(steps = tests = loads = 0;)
    } else {
      t_out[ray] = __int_as_float(0x7f800000);  // +inf
      row_out[ray] = -1;
    }
  };
  // fetch: the counter may still hold rays
  bool fetch = kCounted && next != nullptr;
  if (!fetch) {
    ray = static_cast<int>(blockIdx.x) * kThreads +
          static_cast<int>(threadIdx.x);
    take();
  }
  // the warp's queue: the live rays of its chunk [q_base, q_base + kChunk)
  // not yet handed out, one bit each (warp-uniform)
  const int me = static_cast<int>(threadIdx.x & 31);
  unsigned q[kChunk / 32];
#pragma unroll
  for (int k = 0; k < kChunk / 32; ++k) q[k] = 0u;
  int q_base = 0;
  do {
    if (fetch && __popc(__ballot_sync(kFull, walking)) < kBvhRefill) {
      bool empty = true;
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) empty = empty && q[k] == 0u;
      if (empty) {
        // a new chunk: one atomic a warp; its dead rays answered at once
        ORION_WC(wc_warp_once(kWcTakes);)
        int base = 0;
        if (me == 0) base = atomicAdd(next, kChunk);
        q_base = __shfl_sync(kFull, base, 0);
        fetch = q_base < N;
#pragma unroll
        for (int k = 0; k < kChunk / 32; ++k) {
          const int r = q_base + 32 * k + me;
          const bool live = r < N && alive[r] != 0;
          if (r < N && !live) {
            t_out[r] = __int_as_float(0x7f800000);  // +inf
            row_out[r] = -1;
          }
          q[k] = __ballot_sync(kFull, live);
        }
      }
      // idle lane i of the warp takes the queue's i-th live ray
      const unsigned idle = __ballot_sync(kFull, !walking);
      int n = __popc(idle);
      if (!walking) {
        int rank = __popc(idle & ((1u << me) - 1u));
#pragma unroll
        for (int k = 0; k < kChunk / 32; ++k) {
          const int c = __popc(q[k]);
          if (rank >= 0 && rank < c) {
            ray = q_base + 32 * k +
                  static_cast<int>(__fns(q[k], 0, rank + 1));
            take();
          }
          rank -= c;
        }
      }
      // the handed-out rays leave the queue: its n lowest live bits
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) {
        const int c = __popc(q[k]);
        if (n >= c) {
          q[k] = 0u;
        } else if (n > 0) {
          q[k] &= ~((2u << __fns(q[k], 0, n)) - 1u);
        }
        n = max(n - c, 0);
      }
    }
    if (walking) {
#pragma unroll 1
      for (int s = 0; ptr < M && s < kBvhSteps; ++s) {
        ORION_WC(wc_vote(); ++loads;)
        const int base = ptr;
        float4 n0[kWindow], n1[kWindow];
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
          const int k = min(base + j, M - 1);
          n0[j] = __ldg(nodes + 2 * k);      // lo.xyz, hi.x
          n1[j] = __ldg(nodes + 2 * k + 1);  // hi.yz, skip, start
        }
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
          if (ptr == base + j && ptr < M) {
            ORION_WC(++steps;)
            const float tx0 = (n0[j].x - ox) * ix, tx1 = (n0[j].w - ox) * ix;
            const float ty0 = (n0[j].y - oy) * iy, ty1 = (n1[j].x - oy) * iy;
            const float tz0 = (n0[j].z - oz) * iz, tz1 = (n1[j].y - oz) * iz;
            const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                     fminf(tz0, tz1));
            const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                     fmaxf(tz0, tz1));
            const bool hit = (tmax >= tmin) && (tmax > 0.0f) && (tmin < tb);
            const int start = __float_as_int(n1[j].w);
            int to = (hit && start < 0) ? ptr + 1 : __float_as_int(n1[j].z);
            if (hit && start >= 0) {
              ORION_WC(tests += W;)
              for (int k = start; k < start + W; ++k) {
                const float t = orion::woop_t_rn<true>(tri + 4 * k, ox, oy,
                                                       oz, dx, dy, dz);
                if (t < tb) {  // strict: smallest row, earliest leaf win a tie
                  tb = t;
                  row = k;
                }
              }
              if (kAnyHit && row >= 0) to = M;  // the first hit leaf ends it
            }
            ptr = to;
          }
        }
      }
      if (ptr >= M) {
        row_out[ray] = row;
        t_out[ray] = row < 0 ? __int_as_float(0x7f800000)  // +inf
                             : (kAnyHit ? 1.0f : tb);
        walking = false;
        ORION_WC(wc_add(kWcRays, 1ull); wc_add(kWcSteps, steps);
                 wc_add(kWcTests, tests); wc_add(kWcLoads, loads);)
      }
    }
  } while (fetch || __any_sync(kFull, walking));
  ORION_WC(if ((threadIdx.x & 31) == 0) wc_add(kWcWarps, 1ull);)
}

using Kernel = void (*)(const float*, const float*, const uint8_t*,
                        const float4*, const float4*, int, int, int, float*,
                        int*, int*);

// which = any_hit + 2 counted
Kernel kernel_of(int which) {
  switch (which) {
    case 0: return bvh_intersect_kernel<false, false>;
    case 1: return bvh_intersect_kernel<true, false>;
    case 2: return bvh_intersect_kernel<false, true>;
    default: return bvh_intersect_kernel<true, true>;
  }
}

// the resident blocks of an instantiation on the card, queried at its first
// launch (so that no occupancy query runs inside a CUDA graph's capture)
int resident_blocks(int which) {
  static int blocks[4] = {0, 0, 0, 0};
  int& b = blocks[which];
  if (b == 0) b = orion::persistent_blocks(kernel_of(which), 0, 1 << 30);
  return b;
}

}  // namespace

// `next` is one int32 of scratch: the lane counter of a counted launch
// (zeroed here, on the stream); a spread launch does not use it.
extern "C" int bvh_intersect_launch(const float* orig, const float* dirs,
                                    const uint8_t* alive, const float* nodes,
                                    const float* tri, int M, int W, int N,
                                    int any_hit, float* t_out, int* row_out,
                                    int* next, void* stream) {
  if (N > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int need = (N + kThreads - 1) / kThreads;
    const bool spread = need <= resident_blocks(any_hit);
    const int which = any_hit + (spread ? 0 : 2);
    int blocks = need;
    int* counter = nullptr;
    if (!spread) {
      blocks = min(need, resident_blocks(which));
      const cudaError_t e = cudaMemsetAsync(next, 0, sizeof(int), s);
      if (e != cudaSuccess) return static_cast<int>(e);
      counter = next;
    }
    kernel_of(which)<<<blocks, kThreads, 0, s>>>(
        orig, dirs, alive, reinterpret_cast<const float4*>(nodes),
        reinterpret_cast<const float4*>(tri), M, W, N, t_out, row_out,
        counter);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = [resident blocks an SM, registers, local bytes, static shared
// bytes] of the walk as built: which = any_hit + 2 counted
extern "C" int bvh_intersect_info(int which, int* out) {
  return orion::kernel_info(kernel_of(which), 0, out);
}

#ifdef ORION_WALK_COUNTERS
extern "C" int walk_counters_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_walk_counters,
                                               sizeof(g_walk_counters)));
}
extern "C" int walk_counters_reset() {
  const unsigned long long zero[kWcCount] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_walk_counters, zero, sizeof(zero)));
}
#endif
