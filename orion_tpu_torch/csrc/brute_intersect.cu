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
// once. At the Cornell box's 36 rows
// the sweep is short and the launch and memory traffic dominate; at ~9k rows
// it is ALU-bound.
//
// Design: one thread per ray, all of its state (origin, direction, best t,
// best row) in registers. Rows are staged through shared memory in tiles of
// TILE rows, loaded coalesced by the whole block and then read by every
// thread at the same address (a broadcast, no bank conflicts), so each row
// leaves device memory once per block. A block whose rays are all dead skips
// the sweep (the TPU kernel's lax.cond on the alive row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;          // rows per shared-memory tile (16 KB)
constexpr int kCols = 16;
constexpr float kBig = 3.0e38f;
constexpr float kMtEps = 1e-6f;

// Written with explicit round-to-nearest multiplies and adds so that nvcc
// contracts nothing into FMAs: every test rounds exactly as the plain
// PyTorch version (and the JAX oracle) does, term by term in the same order,
// and the kernel's (t, id) equal the plain version's bit for bit.
__device__ __forceinline__ float dot3(float a, float b, float c, float x,
                                      float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                   __fmul_rn(c, z));
}

__device__ __forceinline__ float woop_t(const float* w, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz) {
  const float ou = __fadd_rn(dot3(w[0], w[1], w[2], ox, oy, oz), w[9]);
  const float ov = __fadd_rn(dot3(w[3], w[4], w[5], ox, oy, oz), w[10]);
  const float ow = __fadd_rn(dot3(w[6], w[7], w[8], ox, oy, oz), w[11]);
  const float du = dot3(w[0], w[1], w[2], dx, dy, dz);
  const float dv = dot3(w[3], w[4], w[5], dx, dy, dz);
  const float dw = dot3(w[6], w[7], w[8], dx, dy, dz);
  const float t = __fdiv_rn(-ow, dw);
  const float u = __fadd_rn(ou, __fmul_rn(t, du));
  const float v = __fadd_rn(ov, __fmul_rn(t, dv));
  const bool ok = (__fmul_rn(fabsf(dw), w[12]) > kMtEps) && (u >= 0.0f) &&
                  (u <= 1.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f) &&
                  (t >= 0.0f);
  return ok ? t : kBig;
}

__global__ void __launch_bounds__(kThreads)
brute_intersect_kernel(const float* __restrict__ orig,
                       const float* __restrict__ dirs,
                       const uint8_t* __restrict__ alive,
                       const float* __restrict__ tri, int T, int N,
                       float* __restrict__ t_out, int* __restrict__ id_out) {
  __shared__ float rows[kTile * kCols];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < N && alive[i] != 0;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  if (live) {
    ox = orig[3 * i]; oy = orig[3 * i + 1]; oz = orig[3 * i + 2];
    dx = dirs[3 * i]; dy = dirs[3 * i + 1]; dz = dirs[3 * i + 2];
  }
  float t_best = kBig;
  int id_best = -1;

  if (__syncthreads_or(live)) {
    for (int base = 0; base < T; base += kTile) {
      const int n = min(kTile, T - base);
      __syncthreads();
      const float4* src = reinterpret_cast<const float4*>(tri + base * kCols);
      float4* dst = reinterpret_cast<float4*>(rows);
      for (int k = threadIdx.x; k < n * (kCols / 4); k += blockDim.x)
        dst[k] = src[k];
      __syncthreads();
      if (live) {
        for (int r = 0; r < n; ++r) {
          const float t = woop_t(rows + r * kCols, ox, oy, oz, dx, dy, dz);
          if (t < t_best) {  // strict: the smallest row wins a tie
            t_best = t;
            id_best = base + r;
          }
        }
      }
    }
  }
  if (i < N) {
    const int id = live ? id_best : -1;
    id_out[i] = id;
    t_out[i] = id >= 0 ? t_best : __int_as_float(0x7f800000);  // +inf
  }
}

}  // namespace

extern "C" int brute_intersect_launch(const float* orig, const float* dirs,
                                      const uint8_t* alive, const float* tri,
                                      int T, int N, float* t_out, int* id_out,
                                      void* stream) {
  if (N > 0) {
    const int blocks = (N + kThreads - 1) / kThreads;
    brute_intersect_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        orig, dirs, alive, tri, T, N, t_out, id_out);
  }
  return static_cast<int>(cudaGetLastError());
}
