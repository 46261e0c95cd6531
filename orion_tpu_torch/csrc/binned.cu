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
// which bins or rows are met. out [2, n]: the new best t and winner row.
//
// What the TPU kernel does and what this one does instead: the TPU kernel
// tests each bundle as a dense [128 rows, 512 lanes] plane for every lane
// of a block and masks the lanes of other bins to a miss. Here a block of
// 128 threads (one per lane) walks the bins present among its lanes
// (the range of its keys, each bin confirmed by a block-wide vote; sorted
// keys keep the range to one or two bins, but the result does not depend
// on the sort); each bundle of a bin
// is staged once into shared memory, one row per thread (13 Woop floats of
// a row as four float4, 8 KB), and only the lanes of that bin test its 128
// rows, reading each staged row as a broadcast. The Woop test is
// fused_common.cuh's woop_t_rn (explicit round-to-nearest arithmetic), so
// (t, row) equal the plain PyTorch version's bit for bit.
//
// What bounds it on the H100: operations. A lane's work is the 39-FP32-op
// Woop test of every row of its bin (up to MAX_ROWS = 512 rows); the
// bytes are the lanes' 40 bytes in and 8 out plus each staged bundle read
// once per block from L2. Blocks whose lanes span two bins pay both bins'
// staging; lanes of the bin not being tested idle meanwhile.

#include "fused_common.cuh"

namespace {

using orion::kBig;

constexpr int kLanes = 128;   // threads per block == rows per bundle
constexpr int kTabF4 = 8;     // a [B_pad, 32] table row as float4s

__global__ void __launch_bounds__(kLanes)
binned_round_kernel(const float* __restrict__ st, const int* __restrict__ key,
                    const int* __restrict__ row0, const int* __restrict__ nb,
                    const float4* __restrict__ tab, int K, int n,
                    float* __restrict__ out) {
  __shared__ float4 rows[kLanes * 4];
  __shared__ int blk_lo, blk_hi;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kLanes + tid;
  const int my = i < n ? key[i] : K;
  if (tid == 0) {
    blk_lo = K;
    blk_hi = -1;
  }
  __syncthreads();
  if (my < K) {   // the block's range of real bins
    atomicMin(&blk_lo, my);
    atomicMax(&blk_hi, my);
  }
  __syncthreads();
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tb = -kBig;
  int rb = 0;
  if (i < n) {
    ox = st[i]; oy = st[n + i]; oz = st[2 * n + i];
    dx = st[3 * n + i]; dy = st[4 * n + i]; dz = st[5 * n + i];
    tb = st[6 * n + i];
    rb = static_cast<int>(st[7 * n + i]);
  }
  const int lo = blk_lo, hi = blk_hi;
  for (int b = lo; b <= hi; ++b) {
    // a bin between two present ones that no lane of the block tests
    if (!__syncthreads_or(my == b)) continue;
    const int r0 = __ldg(row0 + b), count = __ldg(nb + b);
    for (int bundle = 0; bundle < count; ++bundle) {
      const int off = r0 + bundle * kLanes;
      __syncthreads();   // the previous bundle has been read
      const float4* src = tab + static_cast<size_t>(off + tid) * kTabF4;
#pragma unroll
      for (int c = 0; c < 4; ++c) rows[4 * tid + c] = __ldg(src + c);
      __syncthreads();
      if (my != b) continue;
      for (int k = 0; k < kLanes; ++k) {
        const float t =
            orion::woop_t_rn<false>(rows + 4 * k, ox, oy, oz, dx, dy, dz);
        const int r = off + k;
        if (t < kBig && (t < tb || (t == tb && r < rb))) {
          tb = t;
          rb = r;
        }
      }
    }
  }
  if (i < n) {
    out[i] = tb;
    out[n + i] = static_cast<float>(rb);
  }
}

}  // namespace

extern "C" int binned_round_launch(const float* st, const int* key,
                                   const int* row0, const int* nb,
                                   const float* tab, int K, int n, float* out,
                                   void* stream) {
  if (n > 0) {
    binned_round_kernel<<<(n + kLanes - 1) / kLanes, kLanes, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        st, key, row0, nb, reinterpret_cast<const float4*>(tab), K, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
