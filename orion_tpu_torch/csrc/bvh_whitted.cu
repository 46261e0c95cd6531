// The Whitted megakernels over a BVH: the whole Whitted render of a scene
// past the brute sweep's gate in one launch, untextured (7a) or textured
// (7b).
//
// Replaces: orion_tpu/ops/pallas_bvh_whitted.py::_make_kernel (7a, launched
// by make_bvh_whitted_renderer) and ::_make_deferred_kernel together with
// the jnp epilogue that follows it (7b, launched by
// make_bvh_whitted_deferred).
//
// bvh_whitted_kernel (7a): whitted_common.cuh's persistent lane loop
// `whitted_lanes` over a `Tree`: the nearest hit and every light's any-hit
// shadow query are fused_common.cuh's skip-pointer walks over a bundled
// [B_pad, 40] table (the Whitted row: path columns, Ka, Ks, shininess).
// Output [n_lanes, 3] = radiance / spp of the lanes [pix_base, pix_base +
// n_lanes): a tile renders the same pixels as the whole image.
//
// bvh_whitted_textured_kernel (7b): textured Whitted scenes, the same lane
// loop over the [B_pad, 48] table (the corner uvs in columns 40-45) with a
// texel hook (`AtlasTexel`): at a hit it interpolates the uv from the
// corner uvs and reads the hit material's diffuse and specular map entries, the
// nearest texel with a floored-modulo wrap on both axes as
// ops/shade.py::_sample_texture_mat computes it (f32 product, floor,
// floored modulo); a material without a map keeps its solid Kd / Ks, and
// Ka and Ke stay solid. So the mirror chain is folded front to back with
// the textured throughput T * ks(uv), pruned where T is zero, and the lane
// regenerates, as 7a's. Output as 7a's. The TPU kernel cannot gather
// texels: it writes per (sample, bounce, pixel) a record of the bounce's
// texture-independent factors, and a jnp epilogue resolves the texels and
// folds the chain back to front. The port's plain version does the same
// (ops/bvh_whitted.py); the kernel's image equals it up to the sums' order
// (ROADMAP.md, "Standing differences").
//
// The TPU kernels walk one pointer per block of 256 lanes and pick the
// winner's attributes out of the leaf with a one-hot MXU product; a thread
// here walks alone and reads the winner's row once after the walk, with
// the (u, v) of the same Woop test that chose it.
//
// What bounds them on the H100: operations and latency, as kernel 8
// (bvh_path.cu): a slab test is 12 FP32 operations on a 32-byte node row,
// a Woop test 39 on a table row; nodes and table stay in L2 (a 35k-triangle
// scene at leaf width 2: about 0.9 MB of nodes, 5.8 MB of 160-byte rows).
// Both write 12 bytes a pixel; 7b's texels are a few loads a hit from a
// small atlas.
//
// Design (PERF.md; tools/path_probe.py w measures it). One thread a
// pixel made a warp last as long as its slowest pixel: the mirror's pixels
// bounce up to max_depth times while most retire at depth 0 (Ks is 0), and
// a finished lane idled. Persistent lanes (whitted_lanes) take pixels from
// a global counter instead, one atomic a warp; the wrappers hand each
// launch a zeroed int32 counter, and the grid is as many blocks as stay
// resident at kWhittedBlocks an SM (__launch_bounds__).

#include "whitted_common.cuh"

namespace {

using namespace orion;

constexpr int kDCols = 48;              // textured table row width
constexpr int C_UVX = 40, C_UVY = 43;   // corner uvs, corner-major per axis

// Resident blocks an SM that both kernels are built for
// (__launch_bounds__). Measured on the H100 (PERF.md; tools/path_probe.py
// w builds copies of this source with other values). Both walk a TreeF4
// (fused_common.cuh: leaf rows read as float4, measured faster than
// scalar rows at 6-10 blocks).
constexpr int kWhittedBlocks = 8;

using TreeWhitted = WhittedParamsT<TreeF4>;

__global__ void __launch_bounds__(kThreads, kWhittedBlocks)
bvh_whitted_kernel(const TreeWhitted p, int n_lanes, int* next) {
  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)
  whitted_lanes<TreeF4, kWCols>(p, nullptr, n_lanes, next,
                               NoTexel() ORION_PC(, pc));
  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)
}

// 7b's texel hook: the hit material's map entries at the hit's uv. mat_tex
// holds per material the diffuse then the specular map's (h, w, y0, x0) in
// the [AH, AW, 3] atlas, h = 0 where the material has no such map.
struct AtlasTexel {
  const int* mat_tex;   // [n_materials, 8]
  const float* atlas;   // [AH, AW, 3]
  int atlas_w;

  // the nearest texel of one map (floored-modulo wrap), over c where the
  // material has the map
  __device__ __forceinline__ void texel(const int* m, float tu, float tv,
                                        float* c) const {
    const int h = __ldg(m), w = __ldg(m + 1);
    if (h <= 0) return;
    long long ui = static_cast<long long>(floorf(tu * static_cast<float>(w)));
    long long vi = static_cast<long long>(floorf(tv * static_cast<float>(h)));
    ui %= w;
    vi %= h;
    if (ui < 0) ui += w;
    if (vi < 0) vi += h;
    const float* q =
        atlas + ((__ldg(m + 2) + vi) * atlas_w + __ldg(m + 3) + ui) * 3;
    c[0] = __ldg(q);
    c[1] = __ldg(q + 1);
    c[2] = __ldg(q + 2);
  }

  __device__ __forceinline__ void operator()(const float* g, float u, float v,
                                             float* kd, float* ks) const {
    const float wb = 1.0f - u - v;
    const float tu = wb * __ldg(g + C_UVX) + u * __ldg(g + C_UVX + 1) +
                     v * __ldg(g + C_UVX + 2);
    const float tv = wb * __ldg(g + C_UVY) + u * __ldg(g + C_UVY + 1) +
                     v * __ldg(g + C_UVY + 2);
    const int* m = mat_tex + 8 * static_cast<int>(__ldg(g + C_MESH));
    texel(m, tu, tv, kd);
    texel(m + 4, tu, tv, ks);
  }
};

__global__ void __launch_bounds__(kThreads, kWhittedBlocks)
bvh_whitted_textured_kernel(const TreeWhitted p, const AtlasTexel tex,
                            int n_lanes, int* next) {
  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)
  whitted_lanes<TreeF4, kDCols>(p, nullptr, n_lanes, next,
                               tex ORION_PC(, pc));
  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)
}

}  // namespace

// Occupancy and resources of 7a (which 0) or 7b (which 1) as built
// (render_lane.cuh's kernel_info; no shared memory).
extern "C" int bvh_whitted_info(int which, int* out) {
  return which == 0 ? kernel_info(bvh_whitted_kernel, 0, out)
                    : kernel_info(bvh_whitted_textured_kernel, 0, out);
}

// The grid of both launchers: as many blocks as stay resident, or, once
// bvh_whitted_set_grid gave them a count > 0, that many (the tests' check
// that the image is the same for any grid).
static int g_grid = 0;

extern "C" void bvh_whitted_set_grid(int blocks) { g_grid = blocks; }

// `next`: one int32, zero, the persistent lanes' pixel counter (both
// launchers)

extern "C" int bvh_whitted_launch(const float* cam, const float* nodes,
                                  const float* tab, const float* lights,
                                  float* out, int M, int leaf_width,
                                  int copies, int n_lights, int W, int H,
                                  int samples, int max_depth,
                                  int with_emissive, int seed, int pix_base,
                                  int n_lanes, int* next, void* stream) {
  TreeWhitted p{cam,
                TreeF4{{reinterpret_cast<const float4*>(nodes), tab, M,
                       leaf_width, copies}},
                lights, out, n_lights, W, H, samples, max_depth,
                with_emissive, static_cast<uint32_t>(seed), pix_base};
  if (n_lanes > 0) {
    const int blocks = g_grid > 0 ? g_grid
                                  : persistent_blocks(bvh_whitted_kernel, 0,
                                                      n_lanes);
    bvh_whitted_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, n_lanes,
                                                              next);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_whitted_textured_launch(
    const float* cam, const float* nodes, const float* tab,
    const float* lights, const int* mat_tex, const float* atlas,
    int atlas_w, float* out, int M, int leaf_width, int copies,
    int n_lights, int W, int H, int samples, int max_depth,
    int with_emissive, int seed, int pix_base, int n_lanes, int* next,
    void* stream) {
  const TreeWhitted p{cam,
                      TreeF4{{reinterpret_cast<const float4*>(nodes), tab, M,
                             leaf_width, copies}},
                      lights, out, n_lights, W, H, samples, max_depth,
                      with_emissive, static_cast<uint32_t>(seed), pix_base};
  const AtlasTexel tex{mat_tex, atlas, atlas_w};
  if (n_lanes > 0) {
    const int blocks =
        g_grid > 0 ? g_grid
                   : persistent_blocks(bvh_whitted_textured_kernel, 0,
                                       n_lanes);
    bvh_whitted_textured_kernel<<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        p, tex, n_lanes, next);
  }
  return static_cast<int>(cudaGetLastError());
}
