"""Kernel 2's probe (tools/brute_probe.py), the Whitted lane's counter
hooks and blocks sweep (tools/path_probe.py w) and the A/B tool of kernels
2, 7a and 7b (tools/whitted_ab.py) on the CPU: their host arithmetic, the
source rewrites, and the argument handling (the tools themselves need a
card)."""

import pytest

from orion_tpu_torch.ops import cuda_build
from tools import brute_probe, path_probe, whitted_ab


def test_sweep_bound_is_phase_6s():
    """Live rays x rows x 39 FP32 operations over 67 TFLOP/s, against 33
    bytes a live ray, 9 a dead one (its alive byte and its (t, id)) and
    the table once over 3.35 TB/s, a launch."""
    ms, by = brute_probe.sweep_bound(10 * 65536, 65536, 4, 10)
    assert by == "bytes"
    assert ms == pytest.approx((65536 * 33 + 9 * 65536 * 9) / 10 / 3.35e12
                               * 1e3 + 4 * 64 / 3.35e12 * 1e3)
    ms, by = brute_probe.sweep_bound(10 * 65536, 4 * 65536, 36, 10)
    assert by == "operations"
    assert ms == pytest.approx(4 * 65536 * 36 * 39 / 10 / 67e12 * 1e3)
    ms, by = brute_probe.sweep_bound(65536, 65536, 9216, 1)
    assert by == "operations"
    assert ms == pytest.approx(65536 * 9216 * 39 / 67e12 * 1e3)


@pytest.mark.parametrize("n,lanes,blocks", [(65536, 1, 256), (65536, 4, 1024),
                                            (65537, 4, 1025), (1, 8, 1),
                                            (2073600, 1, 8100)])
def test_grid_blocks(n, lanes, blocks):
    assert brute_probe.grid_blocks(n, lanes) == blocks


def test_brute_sweep_rewrites_one_constant(tmp_path):
    """--sweep builds copies of csrc/brute_intersect.cu with one constexpr
    set to each of its values: the source defines each exactly once, and
    each copy differs from it in that line alone."""
    src = cuda_build.CSRC / "brute_intersect.cu"
    text = src.read_text().splitlines()
    paths = brute_probe.sweep_sources(src, tmp_path)
    assert len(paths) == sum(len(v) for v in brute_probe.BRUTE_SWEEP.values())
    for tag, path in paths.items():
        name, value = tag.split("=")
        diff = [(a, b) for a, b in zip(text, path.read_text().splitlines())
                if a != b]
        if not diff:        # the source's own value
            assert f"constexpr int {name} = {value};" in text
            continue
        assert len(diff) == 1
        assert diff[0][1] == f"constexpr int {name} = {value};"


def test_brute_sets_build_constants_together(tmp_path):
    sets = [brute_probe.parse_set("kMaxSplit=4, kTile=128")]
    assert sets[0] == {"kMaxSplit": 4, "kTile": 128}
    paths = brute_probe.sweep_sources(cuda_build.CSRC / "brute_intersect.cu",
                                      tmp_path, sets)
    text = paths["kMaxSplit=4,kTile=128"].read_text()
    assert "constexpr int kMaxSplit = 4;" in text
    assert "constexpr int kTile = 128;" in text
    with pytest.raises(ValueError):
        brute_probe.sweep_sources(cuda_build.CSRC / "brute_intersect.cu",
                                  tmp_path, [{"kNoSuchConstant": 1}])


def test_whitted_ab_arguments(capsys):
    """Anything but OLD NEW or --one ROOT LABEL [DIR] prints the doc and
    returns 2; kernel 2 is timed at (a) on two tables and at (b) on one."""
    assert whitted_ab.main([]) == 2
    assert whitted_ab.main(["a", "b", "c"]) == 2
    assert "whitted_ab.py _archive/old ." in capsys.readouterr().err
    assert whitted_ab.BRUTE_CASES == (("a", 0), ("a", 2), ("b", 0))
    assert set(brute_probe.SETS) == {"a", "b"}


def _per_pixel_checkout():
    """whitted_common.cuh and bvh_whitted.cu shaped as those of a checkout
    whose 7a/7b run the one-thread-a-pixel `whitted_lane` with its whole
    estimator inline: the lane holds each text that the hooks replace, in
    the lane's order, and the two kernels call it a pixel a thread."""
    olds = [old for old, _ in path_probe.WHITTED_LANE_HOOKS]
    wc = ("#pragma once\n" + path_probe.WHITTED_INCLUDE[0]
          + "namespace orion {\n" + path_probe.WHITTED_LANE_START
          + " lane's radiance.\n"
          "template <class G, int kStride = kWCols, class Tex = NoTexel>\n"
          "__device__ __forceinline__ void whitted_lane(\n"
          "    const WhittedParamsT<G>& p, const float* sgeo, int pix,\n"
          + olds[0] + "  float acc[3] = {0.f, 0.f, 0.f};\n" + olds[1]
          + "    if (row >= 0) {\n      float r3[3] = {0.f, 0.f, 0.f};\n"
          + olds[2] + "        r3[0] += 1.0f;\n" + olds[3] + "    }\n"
          "    ++samp;\n  }\n" + olds[4]
          + "  p.out[0] = acc[0] * inv_s;\n}\n\n}  // namespace orion\n")
    bw = ("#include \"whitted_common.cuh\"\nnamespace {\n"
          "void k7a() {\n" + path_probe.WHITTED_KERNEL_HOOKS[0][0] + "}\n"
          "void k7b() {\n" + path_probe.WHITTED_KERNEL_HOOKS[1][0] + "}\n"
          "}  // namespace\n")
    return {"whitted_common.cuh": wc, "bvh_whitted.cu": bw}


def test_hook_whitted_lane_puts_in_the_lane_loops_hooks(tmp_path):
    """A per-pixel checkout's copy: whitted_common.cuh includes the
    counters (render_lane.cuh), whitted_lane gets the hooks of
    whitted_lanes (loop SIMT, nearest and shadow-walk cycles and SIMT,
    the exit time) behind a defaulted counter pointer, the kernels count
    and flush per thread, and bvh_whitted.cu gains bvh_whitted_info. A
    text not found once raises."""
    files = _per_pixel_checkout()
    out = path_probe.hook_whitted_lane(files)
    wc = out["whitted_common.cuh"]
    assert '#include "render_lane.cuh"' in wc
    assert '#include "fused_common.cuh"' not in wc
    lane = wc[wc.index(path_probe.WHITTED_LANE_START):]
    lane = lane[:lane.index("\n}\n")]
    for hook in ("LaneCounters* pcp = nullptr",
                 "pc_warp_vote(pc.iters, pc.iter_lanes)",
                 "pc.nearest += clock64() - pc0",
                 "pc_warp_vote(pc.nee_iters, pc.nee_lanes)",
                 "pc.nee += clock64() - pc1", "pc.t_done = clock64()"):
        assert lane.count(hook) == 1, hook
    bw = out["bvh_whitted.cu"]
    assert bw.count("pc_exit(pc.t_done)") == 2
    assert "whitted_lane(p, nullptr, pix, NoTexel(), &pc);" in bw
    assert "whitted_lane<Tree, kDCols>(p, nullptr, pix, tex, &pc);" in bw
    assert 'extern "C" int bvh_whitted_info(int which, int* out)' in bw
    # whitted_sources applies it to a per-pixel checkout, not to this one
    src = tmp_path / "old"
    src.mkdir()
    for name, text in files.items():
        (src / name).write_text(text)
    assert path_probe.whitted_sources(src, tmp_path / "copy")
    assert (tmp_path / "copy" / "bvh_whitted.cu").read_text() == bw
    assert not path_probe.whitted_sources(cuda_build.CSRC, tmp_path / "new")
    assert ((tmp_path / "new" / "bvh_whitted.cu").read_text()
            == (cuda_build.CSRC / "bvh_whitted.cu").read_text())
    files["bvh_whitted.cu"] = files["bvh_whitted.cu"].replace(
        "whitted_lane(p, nullptr, pix);", "")
    with pytest.raises(ValueError, match="bvh_whitted.cu: 0 matches"):
        path_probe.hook_whitted_lane(files)


def test_whitted_sweep_rewrites_its_constants(tmp_path):
    """7a and 7b are built for kWhittedBlocks resident blocks an SM, a
    constexpr that the probe's sweep rewrites (no -D knob): one copy a
    value of WHITTED_BUILDS, each differing from the source in that line
    alone."""
    src = (cuda_build.CSRC / "bvh_whitted.cu").read_text()
    assert "__launch_bounds__(kThreads, kWhittedBlocks)" in src
    (tmp_path / "bvh_whitted.cu").write_text(src)
    copies = path_probe.whitted_sweep_sources(tmp_path)
    assert len(copies) == len(path_probe.WHITTED_BUILDS) == 7
    for tag, cu in copies.items():
        consts = brute_probe.parse_set(tag)
        out = cu.read_text()
        diff = [(a, c) for a, c in zip(src.splitlines(), out.splitlines())
                if a != c]
        assert len(diff) <= len(consts)
        for name, v in consts.items():
            assert f"constexpr int {name} = {v};" in out


def _per_pixel_kernel4():
    """whitted_common.cuh and whitted.cu shaped as those of a checkout
    whose kernel 4 runs the one-thread-a-pixel `whitted_lane` around the
    ORION_WHITTED_VERTEX macro: each text that the hooks replace, in the
    lane's order, and a kernel that calls the lane a pixel a thread."""
    olds = [old for old, _ in path_probe.WHITTED4_LANE_HOOKS]
    wc = ("#pragma once\n#include \"render_lane.cuh\"\nnamespace orion {\n"
          + path_probe.WHITTED_LANE_START + " lane's radiance.\n"
          "template <class G, int kStride = kWCols, class Tex = NoTexel>\n"
          "__device__ __forceinline__ void whitted_lane(\n"
          "    const WhittedParamsT<G>& p, const float* sgeo, int pix,\n"
          + olds[0] + "  float acc[3] = {0.f, 0.f, 0.f};\n" + olds[1]
          + "      ++samp;\n    )\n  }\n" + olds[2] + "}\n\n"
          "}  // namespace orion\n")
    wt = ("#include \"whitted_common.cuh\"\nnamespace {\n"
          "void whitted_kernel() {\n  const int pix = 0;\n"
          + path_probe.WHITTED4_KERNEL_HOOK[0] + "}\n}  // namespace\n")
    return {"whitted_common.cuh": wc, "whitted.cu": wt}


def test_hook_whitted4_puts_in_the_lane_loops_hooks(tmp_path):
    """A checkout whose kernel 4 runs `whitted_lane`: the copy's lane
    takes a counter pointer (defaulted) and counts the loop's warp votes
    and its exit time, the kernel counts, flushes and records the tails
    in the instrumented build only, and whitted.cu gains whitted_info. A
    text not found once raises. whitted4_sources applies it to such a
    checkout, not to this one (persistent lanes)."""
    files = _per_pixel_kernel4()
    out = path_probe.hook_whitted4(files)
    wc = out["whitted_common.cuh"]
    lane = wc[wc.index(path_probe.WHITTED_LANE_START):]
    for hook in ("LaneCounters* pcp = nullptr", "LaneCounters& pc = *pcp;",
                 "pc_warp_vote(pc.iters, pc.iter_lanes)",
                 "pc.t_done = clock64()"):
        assert lane.count(hook) == 1, hook
    wt = out["whitted.cu"]
    assert wt.count("pc_exit(pc.t_done)") == 1
    assert "whitted_lane(p, sgeo, pix, NoTexel(), &pc);" in wt
    assert wt.index("#else") < wt.index("  whitted_lane(p, sgeo, pix);\n")
    assert 'extern "C" int whitted_info(int T_pad, int* out)' in wt
    src = tmp_path / "old"
    src.mkdir()
    for name, text in files.items():
        (src / name).write_text(text)
    assert path_probe.whitted4_sources(src, tmp_path / "copy")
    assert (tmp_path / "copy" / "whitted.cu").read_text() == wt
    assert not path_probe.whitted4_sources(cuda_build.CSRC, tmp_path / "new")
    assert ((tmp_path / "new" / "whitted.cu").read_text()
            == (cuda_build.CSRC / "whitted.cu").read_text())
    files["whitted.cu"] = files["whitted.cu"].replace(
        "whitted_lane(p, sgeo, pix);", "")
    with pytest.raises(ValueError, match="whitted.cu: 0 matches"):
        path_probe.hook_whitted4(files)


def test_binned_probe_splits_by_the_later_event():
    """tools/binned_probe.py's split of BinnedSweep.phases: the time from
    each event to the next goes to the later one's step, summed over
    rounds and sweeps; the time from a sweep's last event to the next
    sweep's "start" goes to no step."""
    from tools import binned_probe

    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    names = ["start", "order", "select", "key sort", "gather", "kernel",
             "scatter", "select", "finish", "start", "order", "select",
             "finish"]
    times = [0, 5, 6, 8, 9, 12, 13, 14, 15, 20, 22, 23, 24]
    split = binned_probe._split([(n, Ev(t)) for n, t in zip(names, times)])
    assert split == {"order": 7, "select": 3, "key sort": 2, "gather": 1,
                     "kernel": 3, "scatter": 1, "finish": 2}
