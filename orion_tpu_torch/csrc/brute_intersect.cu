// Brute-force nearest-hit sweep: rays against every Woop transform row.
//
// Replaces: orion_tpu/ops/pallas_intersect.py::_brute_kernel (launched by
// _intersect_pallas_impl), the wavefront renderer's accelerator intersect.
//
// Contract (identical to the TPU kernel): for each ray, the nearest t over
// all rows of the [T, 16] table (the 13 Woop floats in columns 0..12), ties
// resolved to the smallest row; misses and dead rays (alive == 0) give
// (t = +inf, id = -1). Ids past the true triangle count are filtered by the
// Python wrapper.
//
// What bounds it on the H100: operations. Each ray-row test is 39 FP32
// operations (three 3-term dot products plus an offset for the origin,
// three for the direction, one divide, two multiply-adds, the eps product)
// and six compares, against 64 bytes of row data that every ray of a block
// reuses; the ray and its two outputs are 33 bytes per ray, read or written
// once. At the Cornell box's 36 rows the sweep is short and the launch and
// memory traffic dominate; at ~9k rows it is ALU-bound.
//
// Design (PERF.md; tools/brute_probe.py measures it). A block takes
// kThreads / K consecutive rays and first compacts its live ones into a
// list in shared memory (a ballot a warp), answering the dead ones at once:
// dead rays hold no lanes, and a block without a live ray leaves. Each live
// ray is then swept by a group of K consecutive lanes: lane j of the group
// tests rows j, j + K, j + 2K, ... in order, keeping the strictly smaller
// t, and the group merges its K bests by the lexicographic minimum of (t,
// row) over __shfl_xor_sync. Each lane's best is the least (t, row) of its
// rows, so the merge is the least (t, row) over all rows: the same winner,
// the smaller row on a tie, whichever lane holds it. The launch picks K by
// the sweep's size: the most lanes a ray, up to kMaxSplit, at which the
// sweep's blocks still fit one wave of the card's resident blocks (a
// 256x256 wavefront's 65,536-ray sweeps fill the card only at two lanes a
// ray; a 1080p wavefront's 2-4M rays fill it at one). Each lane
// unrolls its row loop kUnroll times, so that independent divides
// overlap. Rows are staged in tiles of kTile rows in dynamic shared
// memory as four planes of float4 (chunk c of row r at c * tile + r), so
// the K rows a group reads at once are adjacent 16-byte words (no bank
// conflicts), each read by broadcast to every group of the warp; a table
// that fits one tile (the gate's scenes) is staged once and needs no
// barrier loop.
// A test's arithmetic is the old kernel's, term by term (explicit
// round-to-nearest multiplies and adds, `__fdiv_rn`), so (t, id) equal the
// plain PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// rows a tile (64 B each in shared memory); the most lanes a ray (a power
// of two: 2, the most that a timed sweep takes; only 1 to kMaxSplit are
// built); the unrolling of a lane's row loop; the resident blocks an SM
// the kernel is built for (__launch_bounds__). Measured on the H100
// (PERF.md; tools/brute_probe.py --sweep builds copies of this source with
// other values).
constexpr int kTile = 256;
constexpr int kMaxSplit = 2;
constexpr int kUnroll = 4;
constexpr int kBruteBlocks = 6;
constexpr float kBig = 3.0e38f;
constexpr float kMtEps = 1e-6f;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Written with explicit round-to-nearest multiplies and adds so that nvcc
// contracts nothing into FMAs: every test rounds exactly as the plain
// PyTorch version (and the JAX oracle) does, term by term in the same order,
// and the kernel's (t, id) equal the plain version's bit for bit.
__device__ __forceinline__ float dot3(float a, float b, float c, float x,
                                      float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                   __fmul_rn(c, z));
}

// the test of a row held as a = w0..3, b = w4..7, c = w8..11, e.x = w12
__device__ __forceinline__ float woop_t(const float4 a, const float4 b,
                                        const float4 c, const float4 e,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  const float ou = __fadd_rn(dot3(a.x, a.y, a.z, ox, oy, oz), c.y);
  const float ov = __fadd_rn(dot3(a.w, b.x, b.y, ox, oy, oz), c.z);
  const float ow = __fadd_rn(dot3(b.z, b.w, c.x, ox, oy, oz), c.w);
  const float du = dot3(a.x, a.y, a.z, dx, dy, dz);
  const float dv = dot3(a.w, b.x, b.y, dx, dy, dz);
  const float dw = dot3(b.z, b.w, c.x, dx, dy, dz);
  const float t = __fdiv_rn(-ow, dw);
  const float u = __fadd_rn(ou, __fmul_rn(t, du));
  const float v = __fadd_rn(ov, __fmul_rn(t, dv));
  const bool ok = (__fmul_rn(fabsf(dw), e.x) > kMtEps) && (u >= 0.0f) &&
                  (u <= 1.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f) &&
                  (t >= 0.0f);
  return ok ? t : kBig;
}

template <int K>
__global__ void __launch_bounds__(kThreads, kBruteBlocks)
brute_intersect_kernel(const float* __restrict__ orig,
                       const float* __restrict__ dirs,
                       const uint8_t* __restrict__ alive,
                       const float4* __restrict__ tri, int T, int N,
                       float* __restrict__ t_out, int* __restrict__ id_out) {
  static_assert(K >= 1 && K <= 8 && (K & (K - 1)) == 0,
                "K: a power of two, at most 8 (a block's rays fill warps)");
  constexpr int kRays = kThreads / K;
  extern __shared__ float4 rows[];      // [4][tile]
  __shared__ int live[kRays];
  __shared__ int n_live;
  const int tid = static_cast<int>(threadIdx.x);
  const int base = static_cast<int>(blockIdx.x) * kRays;

  // the block's live rays, in any order (each ray's answer is its own)
  if (tid == 0) n_live = 0;
  __syncthreads();
  if (tid < kRays) {
    const int i = base + tid;
    const bool in = i < N;
    const bool a = in && alive[i] != 0;
    if (in && !a) {
      t_out[i] = __int_as_float(0x7f800000);  // +inf
      id_out[i] = -1;
    }
    const unsigned b = __ballot_sync(kFull, a);
    const int me = tid & 31;
    int at = 0;
    if (me == 0 && b != 0u) at = atomicAdd(&n_live, __popc(b));
    at = __shfl_sync(kFull, at, 0);
    if (a) live[at + __popc(b & ((1u << me) - 1u))] = i;
  }
  __syncthreads();
  const int n = n_live;
  if (n == 0) return;  // block-uniform

  const int g = tid / K, sub = tid % K;
  const bool mine = g < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  if (mine) {
    const int i = live[g];
    ox = orig[3 * i]; oy = orig[3 * i + 1]; oz = orig[3 * i + 2];
    dx = dirs[3 * i]; dy = dirs[3 * i + 1]; dz = dirs[3 * i + 2];
  }
  float tb = kBig;
  int rb = -1;
  const int tile = min(T, kTile);
  for (int t0 = 0; t0 < T; t0 += tile) {
    const int m = min(tile, T - t0);
    if (t0 > 0) __syncthreads();
    for (int k = tid; k < 4 * m; k += kThreads)
      rows[(k & 3) * tile + (k >> 2)] = __ldg(tri + 4 * t0 + k);
    __syncthreads();
    if (mine) {
#pragma unroll kUnroll
      for (int r = sub; r < m; r += K) {
        const float t = woop_t(rows[r], rows[tile + r], rows[2 * tile + r],
                               rows[3 * tile + r], ox, oy, oz, dx, dy, dz);
        if (t < tb) {  // strict: the smallest of this lane's rows wins a tie
          tb = t;
          rb = t0 + r;
        }
      }
    }
  }
  // the group's least (t, row); a miss (kBig, -1) loses to every hit, whose
  // t is below kBig
#pragma unroll
  for (int o = 1; o < K; o <<= 1) {
    const float to = __shfl_xor_sync(kFull, tb, o);
    const int ro = __shfl_xor_sync(kFull, rb, o);
    if (to < tb || (to == tb && static_cast<unsigned>(ro) <
                                    static_cast<unsigned>(rb))) {
      tb = to;
      rb = ro;
    }
  }
  if (mine && sub == 0) {
    const int i = live[g];
    id_out[i] = rb;
    t_out[i] = rb >= 0 ? tb : __int_as_float(0x7f800000);  // +inf
  }
}

using Kernel = void (*)(const float*, const float*, const uint8_t*,
                        const float4*, int, int, float*, int*);

// instantiation `which` runs 1 << which lanes a ray; the instantiations
// are K = 1, 2, ..., kMaxSplit
template <int K = 1>
Kernel kernel_of(int which) {
  if constexpr (K < kMaxSplit) {
    if (which > 0) return kernel_of<2 * K>(which - 1);
  }
  return brute_intersect_kernel<K>;
}

size_t tile_bytes(int T) { return sizeof(float4) * 4 * min(T, kTile); }

// the resident blocks of an instantiation on the card, queried at its first
// launch (so that no occupancy query runs inside a CUDA graph's capture),
// at the largest tile's shared memory
int resident_blocks(int which) {
  static int blocks[4] = {};
  int& b = blocks[which];
  if (b == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(which),
                                                  kThreads,
                                                  tile_bytes(kTile));
    b = max(1, sms * per_sm);
  }
  return b;
}

int blocks_of(int which, int N) {
  const int rays = kThreads >> which;
  return (N + rays - 1) / rays;
}

}  // namespace

// which instantiation a sweep of N rays takes: the most lanes a ray, up to
// kMaxSplit, whose grid fits one wave of resident blocks (else one)
extern "C" int brute_intersect_which(int N) {
  int which = 0;
  while ((2 << which) <= kMaxSplit &&
         blocks_of(which + 1, N) <= resident_blocks(which + 1))
    ++which;
  return which;
}

extern "C" int brute_intersect_launch(const float* orig, const float* dirs,
                                      const uint8_t* alive, const float* tri,
                                      int T, int N, float* t_out, int* id_out,
                                      void* stream) {
  if (N > 0) {
    const int which = brute_intersect_which(N);
    kernel_of(which)<<<blocks_of(which, N), kThreads, tile_bytes(T),
                       static_cast<cudaStream_t>(stream)>>>(
        orig, dirs, alive, reinterpret_cast<const float4*>(tri), T, N, t_out,
        id_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = [resident blocks an SM at a table of T rows, registers, local
// (spill) bytes, static shared bytes, lanes a ray] of instantiation `which`
extern "C" int brute_intersect_info(int which, int T, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel_of(which));
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(a.sharedSizeBytes);
  out[4] = 1 << which;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel_of(which), kThreads, tile_bytes(T)));
}
