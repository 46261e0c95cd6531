// The persistent lane loop of the path megakernels: fused_path.cu (a
// triangle table, kernel 1), bvh_path.cu (a BVH, kernel 8) and prb.cu's
// training pair over a BVH (9a, the forward; 9b, the replay). The training
// pair over a swept table (3a/3b) keeps fused_common.cuh's path_lane.
//
// `render_lanes` is the radiance / spp estimator of
// orion_tpu/ops/pallas_fused.py::_make_regen_body: PCG4D-jittered primary
// ray, nearest hit, depth-0 emission, next-event estimation (`nee` of
// fused_common.cuh, fast-shadow or legacy form), Russian roulette on
// max(kd), cosine bounce, regeneration onto the pixel's next sample. The
// geometry `G` supplies `nearest<kCols>` and the table of winner
// attributes (`p.geo.tab`). Its mode (kRender, kForwardLs, kReplay) adds
// the training pair's records at compile time.
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
// to the last.
// `path_counters_read` / `path_counters_reset` (extern "C", below) read
// and clear them.

#pragma once

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
  kPcCount
};
__device__ unsigned long long g_path_counters[kPcCount];

struct LaneCounters {
  long long t_start = 0, t_done = 0, nearest = 0, nee = 0, acc = 0;
  unsigned long long iters = 0, iter_lanes = 0, nee_iters = 0,
                     nee_lanes = 0, acc_entries = 0, acc_lanes = 0,
                     acc_groups = 0, acc_peers = 0, acc_max = 0;
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
// shadow test of kernel 1; true: the legacy NEE of kernels 8, 9a, 9b).
// kMode:
//   kRender    : write each pixel's radiance / spp to p.out (kernels 1, 8);
//   kForwardLs : the same, with each bounce's contribution rounded op by op
//                (bounce_contrib), plus each sample's radiance L_s to
//                p.ls[(3 s + c) * W H + pix] (kernel 9a);
//   kReplay    : start U at L_s when a sample begins, subtract each
//                bounce's contribution (the forward's own arithmetic) and
//                add the closed-form material adjoints of the pixel's
//                adjoint p.w (read at each hit, not held in registers) to
//                the block's accumulator `sacc` (add_adjoint)
//                and the NEE emitted-color adjoint to the thread's `ek`
//                (kernel 9b).
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
  const int n_pix = p.W * p.H;      // the training modes' plane stride
  float Ls[3] = {0.f, 0.f, 0.f};    // this sample's radiance (forward)
  float U[3] = {0.f, 0.f, 0.f};     // remaining radiance (replay)
  if constexpr (kMode == kReplay) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) U[ch] = __ldg(p.ls + ch * n_pix + pix);
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
      nee<kLegacy>(p, sgeo, upix, site_sd, hx, hy, hz, gnx, gny, gnz, snx,
                   sny, snz, A, sum_scale);
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
        // pixel's adjoint is read here, not held in registers.
        const float w[3] = {__ldg(p.w + 3 * pix), __ldg(p.w + 3 * pix + 1),
                            __ldg(p.w + 3 * pix + 2)};
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
          p.ls[(3 * samp + ch) * n_pix + pix] = Ls[ch];
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
            U[ch] = __ldg(p.ls + (3 * samp + ch) * n_pix + pix);
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
