// One round of the binned dense sweep: each lane tests its ray against
// every row of ONE bin (a maximal subtree of the leaf-128 BVH, a
// contiguous range of 128-row bundles of the bundled table) and improves
// its running winner.
//
// Replaces: orion_tpu/ops/pallas_binned.py::_make_round_kernel(K) (launched
// by build_bin_round_call). The rounds loop around it, the per-ray bin
// order and the gathers stay in PyTorch (ops/binned.py), as they stay in
// jnp in the JAX package.
//
// Contract. n lanes sorted by the bin each tests this round (`key`, int32,
// ascending; K marks a lane with nothing to test). st [8, n] float32 rows:
// origin xyz, direction xyz, the running best t, the running winner row
// as float (exact below 2^24; the module's edge uses 2^22 for "none"). Bin
// b owns the nb[b] bundles of 128 rows from row0[b] of tab [B_pad, 32]
// (the 13 Woop floats first). Each row of the lane's bin is tested; a row
// wins when t < kBig and (t, row) is smaller than the running (t, row)
// (min t, then min row), so the result does not depend on the order in
// which bins, rows or lanes are met, and any split of a lane's rows merges
// exactly by the least (t, row). out [2, n]: the new best t and winner row.
//
// What the TPU kernel does and what this one does instead: the TPU kernel
// tests each bundle as a dense [128 rows, 512 lanes] plane for every lane
// of a block and masks the lanes of other bins to a miss. Here the blocks
// are bin-major: a block serves one bin and one tile of that bin's lanes,
// so a round whose lanes spread over many bins runs their bins side by
// side. `binned_schedule_kernel` (one block) finds each bin's lanes in the
// sorted keys and numbers the blocks bin by bin; `binned_round_kernel`
// finds its bin and tile, stages the bin's rows once (the 13 Woop floats
// of a row as four float4, in four planes: 16 KB a 256-row bin, by
// cp.async and one barrier), and tests them. A bin with few lanes, or a
// round with few lanes, gives each lane S threads (up to a warp) that test
// interleaved rows and merge by the least (t, row) through shuffles; a bin
// of 128 lanes or more in a round of more than kFillThreads / 2 lanes
// takes a thread a lane. A step of kUnroll rows that are all padding (column 12
// <= 0: the Woop test never passes there) is skipped, so the tests are the
// real rows' (BinnedSweep.real_rows). The test is fused_common.cuh's
// woop_t_rn (explicit round-to-nearest arithmetic), so (t, row) equal the
// plain PyTorch version's bit for bit.
//
// What bounds it on the H100: operations. A lane's work is the 39-FP32-op
// Woop test of every real row of its bin; the bytes are the lanes' 40 bytes
// in and 8 out plus each bin's rows read once a block from L2.

#include "fused_common.cuh"

namespace {

using orion::kBig;

constexpr int kLanes = 128;         // threads a block == rows a bundle
constexpr int kMaxSplit = 32;       // threads a lane at most: one warp
constexpr int kStageRows = 512;     // rows staged at a time: 4 bundles
constexpr int kUnroll = 4;          // rows a step of a thread
constexpr int kTabF4 = 8;           // a [B_pad, 32] table row as float4s
constexpr int kSetupThreads = 1024;
// the lane threads a round aims to keep busy: a round of fewer lanes gives
// each lane more threads (up to kMaxSplit), so that a late round's few
// lanes do not each sweep their bin's rows alone
constexpr int kFillThreads = 131072;
// a thread's step of kUnroll rows, kMaxSplit apart, stays in its bundle
static_assert(kMaxSplit * kUnroll <= kLanes && kStageRows % kLanes == 0,
              "a step must not leave the staged rows");

// the threads a lane that a round of n lanes takes at least: the most, up
// to kMaxSplit, that keep n s <= kFillThreads
__host__ __device__ __forceinline__ int round_split(int n) {
  int s = 1;
  while (s < kMaxSplit && 2LL * s * n <= kFillThreads) s <<= 1;
  return s;
}

// the threads that share a lane of a bin of c > 0 lanes in a round of n:
// the most, up to a warp, whose lanes fit one block, and no fewer than
// round_split(n)
__device__ __forceinline__ int split_of(int c, int n) {
  int s = kMaxSplit;
  while (s > 1 && c * s > kLanes) s >>= 1;
  return max(s, round_split(n));
}

// the blocks of a bin of c lanes in a round of n
__device__ __forceinline__ int tiles_of(int c, int n) {
  if (c <= 0) return 0;
  const int per = kLanes / split_of(c, n);
  return (c + per - 1) / per;
}

// the first of key[0, n) (ascending) that is >= b, or n
__device__ __forceinline__ int lower_bound(const int* key, int n, int b) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(key + mid) < b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// The schedule, one block of kSetupThreads: sched[b] = the first lane of
// bin b for b <= K (sched[K]: the first lane keyed K), sched[K + 1 + b] =
// the first block of bin b for b < K, sched[2K + 1] = the bins' blocks in
// all (an exclusive scan of tiles_of over the bins, kSetupThreads at a
// time).
__global__ void __launch_bounds__(kSetupThreads)
binned_schedule_kernel(const int* __restrict__ key, int n, int K,
                       int* sched) {
  __shared__ int warp_sum[kSetupThreads / 32];
  __shared__ int carry;
  for (int b = threadIdx.x; b <= K; b += kSetupThreads)
    sched[b] = lower_bound(key, n, b);
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  int* first = sched + K + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < K; base += kSetupThreads) {
    const int b = base + threadIdx.x;
    const int tiles = b < K ? tiles_of(sched[b + 1] - sched[b], n) : 0;
    int x = tiles;   // the warp's inclusive scan
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int excl = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - tiles;
    if (b < K) first[b] = excl;
    __syncthreads();
    if (threadIdx.x == kSetupThreads - 1) carry = excl + tiles;
    __syncthreads();
  }
  if (threadIdx.x == 0) first[K] = carry;
}

// A block: one tile of one bin's lanes (blocks past the bins' copy the
// lanes keyed K through).
__global__ void __launch_bounds__(kLanes)
binned_round_kernel(const float* __restrict__ st,
                    const int* __restrict__ sched,
                    const int* __restrict__ row0, const int* __restrict__ nb,
                    const float4* __restrict__ tab, int K, int n,
                    float* __restrict__ out) {
  __shared__ float4 rows[4][kStageRows];   // plane q: float4 q of each row
  const int* first = sched + K + 1;
  const int blk = blockIdx.x, tid = threadIdx.x;
  const int blocks = __ldg(first + K);
  if (blk >= blocks) {
    const int i = __ldg(sched + K) + (blk - blocks) * kLanes + tid;
    if (i < n) {
      out[i] = st[6 * n + i];
      out[n + i] = st[7 * n + i];
    }
    return;
  }
  // the bin: the last b < K whose first block is <= blk
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(first + mid) <= blk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int b = lo;
  const int s0 = __ldg(sched + b), c = __ldg(sched + b + 1) - s0;
  const int S = split_of(c, n);
  const int shift = __ffs(S) - 1;
  const int sub = tid & (S - 1);
  const int j = (blk - __ldg(first + b)) * (kLanes >> shift) + (tid >> shift);
  const bool live = j < c;   // the lane's rank in its bin
  const int i = s0 + j;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tb = kBig;
  int rb = 0;
  if (live) {
    ox = st[i]; oy = st[n + i]; oz = st[2 * n + i];
    dx = st[3 * n + i]; dy = st[4 * n + i]; dz = st[5 * n + i];
    tb = st[6 * n + i];
    rb = static_cast<int>(st[7 * n + i]);
  }
  const int r0 = __ldg(row0 + b), R = __ldg(nb + b) * kLanes;
  for (int base = 0; base < R; base += kStageRows) {
    const int m = min(kStageRows, R - base);   // a multiple of kLanes
    if (base > 0) __syncthreads();             // the last rows were read
    const float4* src = tab + static_cast<size_t>(r0 + base) * kTabF4;
    for (int q = tid; q < 4 * m; q += kLanes)
      cp_async16(&rows[q & 3][q >> 2], src + (q >> 2) * kTabF4 + (q & 3));
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (live) {
      for (int k = sub; k < m; k += S * kUnroll) {
        float4 e[kUnroll];
        bool real = false;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          e[u] = rows[3][k + u * S];
          real |= e[u].x > 0.0f;
        }
        if (!real) continue;   // padding rows only: none of them can win
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int kk = k + u * S;
          const float t = orion::woop_t_rn(rows[0][kk], rows[1][kk],
                                           rows[2][kk], e[u], ox, oy, oz,
                                           dx, dy, dz);
          const int r = r0 + base + kk;
          if (t < kBig && (t < tb || (t == tb && r < rb))) {
            tb = t;
            rb = r;
          }
        }
      }
    }
  }
  // the S threads of a lane (an aligned group of a warp) merge by the
  // least (t, row); a dead lane's group merges its own placeholders
  for (int o = S >> 1; o > 0; o >>= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, tb, o);
    const int orow = __shfl_xor_sync(0xffffffffu, rb, o);
    if (ot < tb || (ot == tb && orow < rb)) {
      tb = ot;
      rb = orow;
    }
  }
  if (live && sub == 0) {
    out[i] = tb;
    out[n + i] = static_cast<float>(rb);
  }
}

}  // namespace

// `sched`: 2K + 2 int32 of scratch (the schedule); the grid is the most
// blocks the schedule can number (n round_split(n) / 128 rounded up, plus
// one a bin: a bin's tiles are at most its lanes' share of that, plus one).
extern "C" int binned_round_launch(const float* st, const int* key,
                                   const int* row0, const int* nb,
                                   const float* tab, int K, int n, float* out,
                                   int* sched, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long lanes = static_cast<long long>(n) * round_split(n);
    binned_schedule_kernel<<<1, kSetupThreads, 0, s>>>(key, n, K, sched);
    binned_round_kernel<<<static_cast<int>((lanes + kLanes - 1) / kLanes) + K,
                          kLanes, 0, s>>>(
        st, sched, row0, nb, reinterpret_cast<const float4*>(tab), K, n,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}
