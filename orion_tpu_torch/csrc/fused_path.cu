// Regenerative path-tracing megakernel: the whole path tracer in one launch.
//
// Replaces: orion_tpu/ops/pallas_fused.py::_make_kernel (launched by
// build_fused_call), the estimator of _make_regen_body with fast_shadow=True.
//
// Per pixel lane, until the lane's sample index reaches `samples`:
// PCG4D-jittered primary ray (one jitter per sample, shared by all pixels);
// Woop nearest-hit sweep over the [T_pad, 32] table (min t, ties -> min row);
// depth-0 emission Ke * meshArea * cos; next-event estimation over every
// emissive mesh (<= 8 meshes of <= 8 triangles), `light_samples` draws each,
// visible iff the nearest hit with t < NEE_T_CAP lies on the sampled mesh;
// Russian roulette on max(kd); cosine-weighted bounce; on termination the
// lane regenerates as its next sample. Output: [n_pix, 3] = radiance / spp.
//
// What bounds it on the H100: operations. Every sweep tests each ray
// against every table row, chunk-culled for big tables, and every path
// vertex runs 1 + n_emitters * light_samples sweeps. A test is 39 FP32
// operations (chip_smoke.py's WOOP_TEST_FLOPS): origin transform
// 3 x (3 mul + 3 add), direction transform 3 x (3 mul + 2 add), one divide,
// u/v 2 x (mul + add), the eps product. The bytes are the 128-byte table rows, which stay in L1/L2 (the
// Cornell table is 5 KB, the 16,384-row cap 2 MB), and 12 bytes of output
// per pixel. The other cost is divergence: lanes of a warp sit at different
// depths and samples, so a warp runs as long as its longest lane.
//
// Design: one thread per pixel lane with its whole path state in registers;
// a `while` over (sample, depth) as on the TPU, but each lane leaves the loop
// on its own (no block-wide quiescence test). Tables up to one chunk (512
// rows) are staged once per block into shared memory (13 Woop floats per
// row at a 16-float stride, 32 KB at most) and read by broadcast; larger
// tables are read through the read-only cache in 512-row chunks, each
// chunk's AABB slab-tested per lane against the lane's live segment
// [0, t_best) and skipped when the lane cannot improve (value-identical up
// to rounding at the box boundary; the TPU kernel votes per block). Winner
// attributes are read from the winner's table row only, instead of the TPU
// kernel's select-reduce or one-hot MXU gather.
//
// Random numbers are the TPU kernel's: stateless PCG4D hashes of (pixel,
// sample, depth, site) in wrapping uint32 arithmetic with logical shifts, so
// the image is a pure function of the seed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;          // FUSED_CHUNK
constexpr int kCols = 32;            // table row width
constexpr int kGeo = 16;             // staged Woop row stride
constexpr int kEmStride = 160;       // emitter record (see fused_path.py)
constexpr int kEmHeader = 8;
constexpr int kEmTri = 19;
constexpr float kBig = 3.0e38f;
constexpr float kMtEps = 1e-6f;
constexpr float kBias = 1e-3f;
constexpr float kNeeTCap = 1.05f;

// table columns (pallas_fused.py _C_*)
constexpr int C_N0 = 13, C_N1 = 16, C_N2 = 19, C_KD = 22, C_KE = 25,
              C_AREA = 28, C_MESH = 29;

struct Params {
  const float* cam;   // [12] origin | front | right | up
  const float* tab;   // [T_pad, 32]
  const float* clo;   // [n_chunks, 3]
  const float* chi;   // [n_chunks, 3]
  const float* em;    // [n_em, 160]
  float* out;         // [n_pix, 3]
  int T_pad, n_chunks, n_em, W, H, samples, max_depth, light_samples;
  uint32_t seed;
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

// Woop test of one row; returns the masked t, and (u, v) on request
template <bool kGlobal>
__device__ __forceinline__ float woop(const float* w, const Ray& r,
                                      float* u_out = nullptr,
                                      float* v_out = nullptr) {
  const float w0 = ld<kGlobal>(w + 0), w1 = ld<kGlobal>(w + 1),
              w2 = ld<kGlobal>(w + 2), w3 = ld<kGlobal>(w + 3),
              w4 = ld<kGlobal>(w + 4), w5 = ld<kGlobal>(w + 5),
              w6 = ld<kGlobal>(w + 6), w7 = ld<kGlobal>(w + 7),
              w8 = ld<kGlobal>(w + 8), w9 = ld<kGlobal>(w + 9),
              w10 = ld<kGlobal>(w + 10), w11 = ld<kGlobal>(w + 11),
              w12 = ld<kGlobal>(w + 12);
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

template <bool kGlobal>
__device__ __forceinline__ void sweep_rows(const float* geo, int stride,
                                           int lo, int hi, const Ray& r,
                                           float& t_best, int& row_best) {
  for (int k = lo; k < hi; ++k) {
    const float t = woop<kGlobal>(geo + k * stride, r);
    if (t < t_best) {  // strict: the smallest row (and earliest chunk) wins
      t_best = t;
      row_best = k;
    }
  }
}

// could any row of chunk k improve on t_best? (slab test, flat boxes via >=)
__device__ __forceinline__ bool box_reachable(const Params& p, int k,
                                              const Ray& r, float t_best) {
  const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
  const float tx0 = (__ldg(p.clo + 3 * k) - r.ox) * ix;
  const float tx1 = (__ldg(p.chi + 3 * k) - r.ox) * ix;
  const float ty0 = (__ldg(p.clo + 3 * k + 1) - r.oy) * iy;
  const float ty1 = (__ldg(p.chi + 3 * k + 1) - r.oy) * iy;
  const float tz0 = (__ldg(p.clo + 3 * k + 2) - r.oz) * iz;
  const float tz1 = (__ldg(p.chi + 3 * k + 2) - r.oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fmaxf(tz0, tz1));
  return (tmax >= tmin) && (tmax > 0.0f) && (tmin < t_best);
}

// nearest row with t < cap (ties -> min row), or -1
__device__ __forceinline__ int nearest(const Params& p, const float* sgeo,
                                       const Ray& r, float cap, float& t) {
  float t_best = cap;
  int row = -1;
  if (p.n_chunks <= 1 && p.T_pad <= kChunk) {
    sweep_rows<false>(sgeo, kGeo, 0, p.T_pad, r, t_best, row);
  } else {
    for (int k = 0; k < p.n_chunks; ++k) {
      if (box_reachable(p, k, r, t_best))
        sweep_rows<true>(p.tab, kCols, k * kChunk, (k + 1) * kChunk, r,
                         t_best, row);
    }
  }
  t = t_best;
  return row;
}

__device__ __forceinline__ void primary(const Params& p, const float* cam,
                                        int pix, int samp, Ray& r) {
  uint32_t a = static_cast<uint32_t>(samp), b = p.seed, c = 0x4A17u,
           d = 0x7E57u;
  pcg4d(a, b, c, d);
  const float jx = u01(a) * static_cast<float>(2.0 / p.W);
  const float jy = u01(b) * static_cast<float>(2.0 / p.H);
  const int i = pix / p.W;  // == floor((pix + 0.5) * (1/W)) for these sizes
  const float fi = static_cast<float>(i);
  const float fj = static_cast<float>(pix - i * p.W);
  const float x = 2.0f * (fj * static_cast<float>(1.0 / p.W)) - 1.0f + jx;
  const float y = -(2.0f * (fi * static_cast<float>(1.0 / p.H)) - 1.0f + jy);
  r.ox = cam[0]; r.oy = cam[1]; r.oz = cam[2];
  r.dx = cam[3] + x * cam[6] + y * cam[9];
  r.dy = cam[4] + x * cam[7] + y * cam[10];
  r.dz = cam[5] + x * cam[8] + y * cam[11];
}

__global__ void __launch_bounds__(kThreads)
fused_path_kernel(const Params p) {
  extern __shared__ float sgeo[];  // resident tables only: [T_pad, 16]
  const bool resident = p.n_chunks <= 1 && p.T_pad <= kChunk;
  if (resident) {
    for (int k = threadIdx.x; k < p.T_pad * 13; k += blockDim.x) {
      const int row = k / 13, col = k - row * 13;
      sgeo[row * kGeo + col] = __ldg(p.tab + row * kCols + col);
    }
    __syncthreads();
  }
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_pix = p.W * p.H;
  if (pix >= n_pix) return;

  float cam[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) cam[k] = __ldg(p.cam + k);
  const uint32_t upix = static_cast<uint32_t>(pix);
  const float inv_ls = static_cast<float>(1.0 / p.light_samples);

  Ray r;
  int samp = 0, depth = 0;
  primary(p, cam, pix, 0, r);
  float tr = 1.f, tg = 1.f, tb = 1.f, ar = 0.f, ag = 0.f, ab = 0.f;

  while (samp < p.samples) {
    float t;
    const int row = nearest(p, sgeo, r, kBig, t);
    const bool hit = row >= 0;
    const uint32_t site_sd = static_cast<uint32_t>(samp) * 131071u +
                             static_cast<uint32_t>(depth);
    float kdr = 0.f, kdg = 0.f, kdb = 0.f;
    float hx = 0.f, hy = 0.f, hz = 0.f, snx = 0.f, sny = 0.f, snz = 0.f;
    if (hit) {
      const float* g = p.tab + row * kCols;
      float u, v;
      woop<true>(g, r, &u, &v);
      hx = r.ox + t * r.dx; hy = r.oy + t * r.dy; hz = r.oz + t * r.dz;
      const float w = 1.0f - u - v;
      snx = w * __ldg(g + C_N0) + u * __ldg(g + C_N1) + v * __ldg(g + C_N2);
      sny = w * __ldg(g + C_N0 + 1) + u * __ldg(g + C_N1 + 1) +
            v * __ldg(g + C_N2 + 1);
      snz = w * __ldg(g + C_N0 + 2) + u * __ldg(g + C_N1 + 2) +
            v * __ldg(g + C_N2 + 2);
      norm3(snx, sny, snz);
      // geometric normal: the Woop w-row rescaled by |n|
      const float s = sqrtf(__ldg(g + 12));
      const float gnx = __ldg(g + 6) * s, gny = __ldg(g + 7) * s,
                  gnz = __ldg(g + 8) * s;
      kdr = __ldg(g + C_KD); kdg = __ldg(g + C_KD + 1);
      kdb = __ldg(g + C_KD + 2);

      // depth-0 emissive term: Ke * meshArea * dot(norm(d), -s_n)
      float ndx = r.dx, ndy = r.dy, ndz = r.dz;
      norm3(ndx, ndy, ndz);
      const float cosv = -(ndx * snx + ndy * sny + ndz * snz);
      const float em_scale = depth == 0 ? __ldg(g + C_AREA) * cosv : 0.0f;
      float rr = __ldg(g + C_KE) * em_scale;
      float rg = __ldg(g + C_KE + 1) * em_scale;
      float rb = __ldg(g + C_KE + 2) * em_scale;

      // next-event estimation, fast-shadow form
      Ray sray;
      sray.ox = hx + kBias * gnx;
      sray.oy = hy + kBias * gny;
      sray.oz = hz + kBias * gnz;
      float A0 = 0.f, A1 = 0.f, A2 = 0.f;
      for (int mi = 0; mi < p.n_em; ++mi) {
        const float* E = p.em + mi * kEmStride;
        const float mesh = __ldg(E);
        const int count = static_cast<int>(__ldg(E + 1));
        for (int ls = 0; ls < p.light_samples; ++ls) {
          const int site = ls + p.light_samples * mi;
          uint32_t a = upix, b = site_sd,
                   c = 0x11u + 0x101u * static_cast<uint32_t>(site),
                   d = p.seed;
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
          const float lw = 1.0f - la - lb;
          float lnx = lw * __ldg(L + 10) + la * __ldg(L + 13) + lb * __ldg(L + 16);
          float lny = lw * __ldg(L + 11) + la * __ldg(L + 14) + lb * __ldg(L + 17);
          float lnz = lw * __ldg(L + 12) + la * __ldg(L + 15) + lb * __ldg(L + 18);
          norm3(lnx, lny, lnz);
          float ldx = sdx, ldy = sdy, ldz = sdz;
          norm3(ldx, ldy, ldz);
          const float cos_s = snx * ldx + sny * ldy + snz * ldz;
          const float cos_l = -(lnx * ldx + lny * ldy + lnz * ldz);
          const float geom = cos_s * cos_l;
          if (!(geom > 0.0f)) continue;  // contributes 0 whatever is visible
          sray.dx = sdx; sray.dy = sdy; sray.dz = sdz;
          float ts;
          const int srow = nearest(p, sgeo, sray, kNeeTCap, ts);
          if (srow < 0 || __ldg(p.tab + srow * kCols + C_MESH) != mesh)
            continue;
          const float d2 = sdx * sdx + sdy * sdy + sdz * sdz;
          const float scale = geom * __ldg(L + 9) / (1.0f + d2) * inv_ls;
          A0 += __ldg(E + 2) * scale;
          A1 += __ldg(E + 3) * scale;
          A2 += __ldg(E + 4) * scale;
        }
      }
      rr += kdr * A0; rg += kdg * A1; rb += kdb * A2;
      ar += tr * rr; ag += tg * rg; ab += tb * rb;
    }

    // Russian roulette + cosine bounce
    uint32_t a = upix, b = site_sd, c = 0x5EEDu, d = p.seed;
    pcg4d(a, b, c, d);
    const float u_rr = u01(a), u1 = u01(b), u2 = u01(c);
    const float p_cont = fmaxf(fmaxf(kdr, kdg), kdb);
    if (hit && depth < p.max_depth && u_rr <= p_cont) {
      const float inv_p = p_cont > 0.0f ? 1.0f / p_cont : 0.0f;
      const float sin_th = sqrtf(u1);
      const float cos_th = sqrtf(fmaxf(1.0f - u1, 0.0f));
      const float psi = u2 * 6.28318548202514648f;  // float32(2 pi)
      float t1x = snz, t1y = 0.0f, t1z = -snx;
      if (t1x * t1x + t1z * t1z == 0.0f) {
        t1x = -sny;
        t1y = snx;
      }
      norm3(t1x, t1y, t1z);
      const float btx = sny * t1z - snz * t1y;
      const float bty = snz * t1x - snx * t1z;
      const float btz = snx * t1y - sny * t1x;
      const float ca = sin_th * cosf(psi);
      const float cb = sin_th * sinf(psi);
      r.dx = ca * t1x + cb * btx + cos_th * snx;
      r.dy = ca * t1y + cb * bty + cos_th * sny;
      r.dz = ca * t1z + cb * btz + cos_th * snz;
      r.ox = hx + snx * kBias;
      r.oy = hy + sny * kBias;
      r.oz = hz + snz * kBias;
      tr = tr * kdr * inv_p;
      tg = tg * kdg * inv_p;
      tb = tb * kdb * inv_p;
      ++depth;
    } else {
      // terminate: regenerate as the lane's next sample
      ++samp;
      depth = 0;
      tr = tg = tb = 1.0f;
      if (samp < p.samples) primary(p, cam, pix, samp, r);
    }
  }
  const float inv_s = static_cast<float>(1.0 / p.samples);
  p.out[3 * pix + 0] = ar * inv_s;
  p.out[3 * pix + 1] = ag * inv_s;
  p.out[3 * pix + 2] = ab * inv_s;
}

}  // namespace

extern "C" int fused_path_launch(const float* cam, const float* tab,
                                 const float* clo, const float* chi,
                                 const float* em, float* out, int T_pad,
                                 int n_chunks, int n_em, int W, int H,
                                 int samples, int max_depth,
                                 int light_samples, int seed, void* stream) {
  Params p{cam, tab, clo, chi, em, out, T_pad, n_chunks, n_em, W, H,
           samples, max_depth, light_samples, static_cast<uint32_t>(seed)};
  const int n_pix = W * H;
  const bool resident = n_chunks <= 1 && T_pad <= kChunk;
  const size_t smem = resident ? sizeof(float) * T_pad * kGeo : 0;
  if (n_pix > 0) {
    fused_path_kernel<<<(n_pix + kThreads - 1) / kThreads, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
