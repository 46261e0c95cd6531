"""tools/path_probe.py's reading of nvcc's report and of the lane-loop
counters, on the CPU (the probe itself needs a card): the numbers that
PERF.md takes from it are these formulas."""

import pytest

from tools import path_probe

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N_fused_path_kernelEN5orion11PathParamsTINS0_4RGeoEEEPi' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N_fused_path_kernelEN5orion11PathParamsTINS0_4RGeoEEEPi
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N_other_kernelEv' for 'sm_90a'
ptxas info    : Used 12 registers
"""


def test_ptxas_lines_of_one_kernel():
    lines = path_probe._ptxas_lines(LOG, "fused_path_kernel")
    assert len(lines) == 3
    assert lines[1] == ("8 bytes stack frame, 4 bytes spill stores, 8 bytes "
                        "spill loads")
    assert lines[2].startswith("ptxas info    : Used 80 registers")
    assert path_probe._ptxas_lines(LOG, "bvh_path_kernel") == []


def _counters(**kw):
    c = dict.fromkeys(path_probe.COUNTERS, 0)
    c.update(kw)
    return c


@pytest.mark.parametrize("threads", [1, 64])
def test_report_counters(capsys, threads):
    """A thread's cycles split among nearest-hit queries, NEE and the
    rest; SIMT efficiency = active lanes / (32 x warp iterations); the
    tails per warp and per block as shares of a thread's cycles."""
    c = _counters(lane_cycles=1000 * threads, nearest_cycles=250 * threads,
                  nee_cycles=400 * threads, iters=10, iter_lanes=240,
                  nee_iters=4, nee_lanes=64, warp_tail=300, warps=3,
                  block_tail=100, blocks=1, lanes=threads)
    path_probe._report_counters("k", c)
    out = capsys.readouterr().out
    assert "a thread: 1000 cycles" in out
    assert "nearest-hit queries 0.2500, NEE 0.4000" in out
    assert "loop) 0.3500" in out
    assert "loop 0.7500 over 10 warp iterations (3.3 a warp)" in out
    assert "NEE entries 0.5000" in out
    assert "100 cycles a warp (0.1000 of a thread's cycles)" in out
    assert "100 a block (0.1000)" in out
    # no thread counted: the raw counters only
    path_probe._report_counters("k", _counters())
    assert "a thread" not in capsys.readouterr().out


def test_report_accumulation_shares(capsys):
    """The replay's accumulation: its share of a thread's cycles (taken
    out of "the rest"), and per warp entry its active lanes, distinct
    materials, the collision degree (lanes on a lane's material, averaged
    over lanes) and the largest group."""
    c = _counters(lane_cycles=1000, nearest_cycles=300, nee_cycles=400,
                  acc_cycles=100, iters=4, iter_lanes=128, lanes=1,
                  acc_entries=4, acc_lanes=96, acc_groups=10,
                  acc_peers=1536, acc_max=80)
    path_probe._report_counters("k", c)
    out = capsys.readouterr().out
    assert "loop) 0.2000" in out
    assert "adjoint accumulation: 0.1000 of a thread's cycles" in out
    assert "24.0000 active lanes, 2.5000 distinct materials" in out
    assert "collision degree 16.0000, largest group 20.0000 (4 entries)" in out
    # a kernel without the accumulation prints no such line
    path_probe._report_counters("k", _counters(lane_cycles=10, lanes=1))
    assert "accumulation" not in capsys.readouterr().out


def test_report_paired_shadow_sweep_shares(capsys):
    """Kernel 1's paired shadow sweeps: warp entries per NEE entry, their
    SIMT efficiency (active lanes / (32 x entries)), and the shares of
    their lanes that need both samples' winners and that need one."""
    c = _counters(lane_cycles=1000, nee_cycles=500, iters=10,
                  iter_lanes=300, nee_iters=8, nee_lanes=200, lanes=1,
                  pair_iters=4, pair_lanes=100, pair_both=90, pair_one=10)
    path_probe._report_counters("kernel 1", c)
    out = capsys.readouterr().out
    assert ("paired shadow sweeps: 4 warp entries (0.5000 a NEE entry), "
            "SIMT 0.7812") in out
    assert "0.9000 need both samples' winners, 0.1000 one" in out
    # a kernel that sweeps one shadow ray at a time prints no such line
    path_probe._report_counters("k", _counters(lane_cycles=10, lanes=1,
                                               nee_iters=3))
    assert "paired" not in capsys.readouterr().out


SASS = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_121bvh_prb_replay_kernelEN5orion11PathParamsTINS0_4TreeEEEPiPdi
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0a10*/                   ATOMS.CAST.SPIN.64 P0, [R2], R4, R6 ;
        /*0a20*/              @!P0 BRA 0x9f0 ;
        /*0b30*/                   REDG.E.ADD.F64.RN.STRONG.GPU desc[UR4][R2.64], R4 ;
        /*0b40*/                   ATOMS.CAST.SPIN.64 P0, [R3], R4, R6 ;
		Function : _ZN12_GLOBAL__N_118bvh_prb_fwd_kernelEN5orion11PathParamsTINS0_4TreeEEEPi
        /*0100*/                   ATOMG.E.ADD.STRONG.GPU PT, R5, desc[UR4][R2.64], R7 ;
"""


def test_sass_atomics_of_one_kernel():
    """Atomic and reduction opcodes counted in the named function only."""
    assert path_probe._sass_atomics(SASS, "bvh_prb_replay_kernel") == {
        "ATOMS.CAST.SPIN.64": 2, "REDG.E.ADD.F64.RN.STRONG.GPU": 1}
    assert path_probe._sass_atomics(SASS, "bvh_prb_fwd_kernel") == {
        "ATOMG.E.ADD.STRONG.GPU": 1}
    assert path_probe._sass_atomics(SASS, "bvh_prb_replay_kernel",
                                    "Geo") == {}


def test_sass_diff_reads_functions_without_addresses():
    """tools/sass_diff.py's reading of cuobjdump -sass: a function's
    instruction lines (both halves of each encoding) without their
    addresses and with runs of blanks made one, so that one kernel's code
    is compared across two builds whatever its mangled name's file hash
    and the column cuobjdump pads its encodings to."""
    from tools import sass_diff

    def dump(nsp, pad):
        return (f"\t\tFunction : _ZN{nsp}17prb_fwd_ls_kernelIN5orion3GeoEEEv\n"
                "\t.headerflags\t@\"EF_CUDA_SM90\"\n"
                "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
                f"{' ' * pad}/* 0x00000a00ff017b82 */\n"
                "                                      "
                "  /* 0x000fe20000000800 */\n"
                f"        /*0010*/                   EXIT ;"
                "  /* 0x000000000000794d */\n")

    a = sass_diff.functions(dump("38_GLOBAL__N__ce40035e_6_prb_cu_bd0cfce1",
                                 2))
    b = sass_diff.functions(dump("38_GLOBAL__N__0badf00d_6_prb_cu_12345678",
                                 9))
    fa = sass_diff.pick(a, "prb_fwd_ls_kernel", ("Geo",))
    assert fa == sass_diff.pick(b, "prb_fwd_ls_kernel", ("Geo",))
    assert len(fa) == 3
    assert fa[0] == "LDC R1, c[0x0][0x28] ; /* 0x00000a00ff017b82 */"
    assert sass_diff.pick(a, "prb_fwd_ls_kernel", ("Tree",)) is None


# kernel 9b's counters as the probe read them from the replay built for 10
# resident blocks, 1920x1080, 4 spp, depth 8 (PERF.md's "9b after" column)
REPLAY_COUNTERS = dict(
    lane_cycles=4187780712763, nearest_cycles=1265657331704,
    nee_cycles=1730779949665, iters=478784, iter_lanes=14080225,
    nee_iters=462315, nee_lanes=9375997, warp_tail=14945970685, warps=5280,
    block_tail=4592282115, blocks=1320, lanes=168960,
    acc_cycles=161846584969, acc_entries=462315, acc_lanes=9375997,
    acc_groups=2493217, acc_peers=66839447, acc_max=4100135)


def test_report_of_recorded_replay_counters(capsys):
    """The replay's recorded counters give the shares, SIMT, tails and
    collisions that PERF.md's table states."""
    path_probe._report_counters("9b", _counters(**REPLAY_COUNTERS))
    out = capsys.readouterr().out
    assert "nearest-hit queries 0.3022, NEE 0.4133" in out
    assert "loop) 0.2458" in out
    assert "loop 0.9190 over 478784 warp iterations" in out
    assert "NEE entries 0.6338" in out
    assert "(0.1142 of a thread's cycles)" in out and "(0.1404)" in out
    assert "adjoint accumulation: 0.0386 of a thread's cycles" in out
    assert "20.2805 active lanes, 5.3929 distinct materials" in out
    assert "collision degree 7.1288, largest group 8.8687" in out


@pytest.mark.parametrize("argv,kernels,root", [
    ([], {"1", "8", "9", "3", "w"}, None),
    (["3"], {"3"}, None),
    (["9", "3", "--root", "_archive/old"], {"9", "3"}, "_archive/old"),
])
def test_parse_args_names_kernels_and_a_checkout(argv, kernels, root):
    """`path_probe.py [1] [8] [9] [3] [w] [--root CHECKOUT]`: the kernels
    named, all five when none is; the checkout to probe, or this one."""
    args = path_probe.parse_args(argv)
    assert args.kernels == kernels
    assert (args.root is None if root is None else str(args.root) == root)


def test_parse_args_refuses_an_unknown_kernel():
    with pytest.raises(SystemExit):
        path_probe.parse_args(["4"])


@pytest.mark.parametrize("pair,constant", [("3", "kTableBlocks"),
                                           ("9", "kTreeBlocks")])
def test_sweep_rewrites_the_blocks_constant(tmp_path, pair, constant):
    """The sweep's copies of csrc/prb.cu differ from it in the line of
    the pair's `constexpr int` alone, one copy a value of TRAIN_BLOCKS;
    prb.cu sets each pair's blocks by such a constexpr, with no -D knob."""
    from orion_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "prb.cu").read_text()
    assert "#ifndef" not in src and "ORION_PRB_BLOCKS" not in src
    assert path_probe.BLOCKS_CONSTANT[pair] == constant
    assert not path_probe.prb_sources(cuda_build.CSRC, tmp_path)
    assert (tmp_path / "prb.cu").read_text() == src
    assert (tmp_path / "render_lane.cuh").exists()
    copies = path_probe.sweep_sources(tmp_path, pair)
    assert sorted(copies) == sorted(path_probe.TRAIN_BLOCKS)
    assert {6, 10, 12} <= set(copies)
    for blocks, cu in copies.items():
        out = cu.read_text()
        diff = [(a, b) for a, b in zip(src.splitlines(), out.splitlines())
                if a != b]
        assert len(out.splitlines()) == len(src.splitlines())
        assert len(diff) <= 1
        assert f"constexpr int {constant} = {blocks};" in out


def _path_lane_checkout():
    """The layout of a checkout whose 3a/3b run fused_common.cuh's
    one-thread-a-pixel path_lane: each text that hook_path_lane replaces,
    once, around lines of its own."""
    lane = "\n".join(["// One pixel lane, until its sample index reaches "
                      "p.samples. kReplay reads",
                      "template <bool kLegacy, int kMode, class P>",
                      "__device__ __forceinline__ void path_lane(const P& p,",
                      "    const float* sgeo, int pix,",
                      "    " + path_probe.LANE_HOOKS[0][0]]
                     + [old for old, _ in path_probe.LANE_HOOKS[1:]]
                     + ["}", "", ""])
    fused_common = ("#pragma once\nnamespace orion {\nstruct Geo {};\n"
                    + lane + "}  // namespace orion\n")
    render_lane = ("#pragma once\n#include \"fused_common.cuh\"\n"
                   "namespace orion {\nstruct LaneCounters {};\n"
                   + path_probe.RENDER_LANE_END + "extern \"C\" int f();\n"
                   "#endif\n")
    prb = ("#include \"render_lane.cuh\"\nvoid fwd() {\n"
           + "\n".join(old for old, _ in path_probe.KERNEL_HOOKS) + "}\n")
    return {"fused_common.cuh": fused_common,
            "render_lane.cuh": render_lane, "prb.cu": prb}


def test_hook_path_lane_moves_the_lane_and_puts_in_hooks(tmp_path):
    """A path_lane checkout's copy: path_lane leaves fused_common.cuh for
    the end of render_lane.cuh's namespace (after the counters), with
    every hook of render_lanes (loop SIMT, nearest and NEE cycles, NEE
    SIMT, the replay's accumulation and collisions, the tail); the
    kernels count and flush per thread, and prb.cu gains prb_info. A
    text not found once raises."""
    files = _path_lane_checkout()
    out = path_probe.hook_path_lane(files)
    assert "path_lane" not in out["fused_common.cuh"]
    assert out["fused_common.cuh"].endswith("}  // namespace orion\n")
    rl = out["render_lane.cuh"]
    assert rl.index("struct LaneCounters") < rl.index("path_lane(") \
        < rl.index("#ifdef ORION_PATH_COUNTERS")
    for hook in ("ORION_PC_ARG", "pc_warp_vote(pc.iters, pc.iter_lanes)",
                 "pc.nearest += clock64() - pc0",
                 "pc_warp_vote(pc.nee_iters, pc.nee_lanes)",
                 "pc.nee += clock64() - pc1", "pc_acc_vote(pc, mat)",
                 "pc.acc += clock64() - pc2", "pc.t_done = clock64()"):
        assert rl.count(hook) == 1, hook
    prb = out["prb.cu"]
    assert prb.count("pc_exit(pc.t_done)") == 2
    assert prb.count("pc_flush(pc)") == 2
    assert 'extern "C" int prb_info(int which, int T_pad, int* out)' in prb
    # the forward's uninstrumented branch is the checkout's own code
    assert path_probe.KERNEL_HOOKS[0][0] in prb
    # prb_sources applies it to a checkout of path_lane
    src = tmp_path / "old"
    src.mkdir()
    for name, text in files.items():
        (src / name).write_text(text)
    assert path_probe.prb_sources(src, tmp_path / "copy")
    assert (tmp_path / "copy" / "prb.cu").read_text() == prb
    files["prb.cu"] = files["prb.cu"].replace("if (pix >= p.W * p.H)", "")
    with pytest.raises(ValueError, match="prb.cu: 0 matches"):
        path_probe.hook_path_lane(files)


def test_prb_ab_cornell_case_on_cpu(tmp_path):
    """tools/prb_ab.py's Cornell pair at a CPU size: the red wall problem
    on the Cornell box through make_fused_train_step (the plain versions
    on CPU tensors), the forward's image and planes, the MSE cotangent
    and a step's loss and gradients."""
    import torch

    from orion_tpu_torch.ops import prb
    from tools import prb_ab

    shapes = dict(xres=8, yres=6, samples=2, depth=2)
    c = prb_ab.cornell_case(tmp_path, "cpu", shapes=shapes)
    assert isinstance(c["plan"], prb.PRBPlan)
    assert (c["plan"].W, c["plan"].H, c["plan"].samples) == (8, 6, 2)
    assert c["tab"].shape[1] == 32 and c["tab"].device.type == "cpu"
    assert c["img"].shape == (48, 3) and c["ls"].shape == (48, 6)
    assert c["w"].shape == (48, 3) and c["w"].is_contiguous()
    assert c["img"].mean() > 0
    red = int(torch.argmax(c["params"]["mat_diffuse"][:, 0]
                           - c["params"]["mat_diffuse"][:, 1]))
    loss, grads = c["step"](c["params"], 3)
    assert float(loss) > 0 and set(grads) == {"mat_diffuse", "mat_emissive"}
    assert torch.isfinite(grads["mat_diffuse"]).all()
    assert float(grads["mat_diffuse"][red].abs().sum()) > 0
    assert [p[:2] for p in prb_ab.PAIRS] == [("3a", "3b"), ("9a", "9b")]


def test_sass_diff_lists_every_instantiation():
    """sass_diff's kernels: 1, 3a, 3b, the four instantiations of 5, 8,
    9a, 9b, 6a, the draw kernel of 6b's launch entry and the four shade
    instantiations, each picked by a string that one mangled name alone
    contains (3a's and 3b's with the length before the name, which 9a's
    and 9b's do not share); kernels 2, 4, 7a, 7b, 10, 11 and 6b's vis
    kernel, which the redesigns changed, are not listed."""
    from tools import sass_diff

    names = {(s, k, a) for s, k, a in sass_diff.KERNELS}
    assert len(names) == len(sass_diff.KERNELS) == 16
    assert not {k for _, k, _ in names} & {"brute_intersect_kernel",
                                           "bvh_whitted_kernel",
                                           "bvh_whitted_textured_kernel",
                                           "whitted_kernel",
                                           "binned_round_kernel",
                                           "bvh_g8_kernel",
                                           "bounce_vis_kernel"}
    walks = {f"_ZN12_GLOBAL__N_120bvh_intersect_kernelILb{a}ELb{c}EEEvPKf":
             [f"{a}{c}"] for a in (0, 1) for c in (0, 1)}
    for src, kernel, also in sass_diff.KERNELS:
        if src == "bvh_intersect":
            got = sass_diff.pick(walks, kernel, also)
            assert got == ["".join(c for c in also[0] if c.isdigit())]
    assert ("bounce", "bounce_walk_kernel", ()) in names
    assert ("bounce", "bounce_draw_kernel", ()) in names
    funcs = {f"_ZN12_GLOBAL__N_119bounce_shade_kernelILb{a}ELb{v}EEEvN5o"
             f"rion12BounceParamsEPf": [f"{a}{v}"]
             for a in (0, 1) for v in (0, 1)}
    funcs.update({f"_ZN12_GLOBAL__N_1{len(k)}{k}EN5orion5PathPiPdi": [k]
                  for k in ("prb_replay_kernel", "bvh_prb_replay_kernel",
                            "prb_fwd_ls_kernel", "bvh_prb_fwd_kernel")})
    for src, kernel, also in sass_diff.KERNELS:
        if kernel == "bounce_shade_kernel":
            got = sass_diff.pick(funcs, kernel, also)
            assert got == ["".join(c for c in also[0] if c.isdigit())]
        elif src == "prb":
            got = sass_diff.pick(funcs, kernel, also)
            assert got is not None and kernel.endswith(got[0])


def test_sass_loops_finds_backward_branches():
    """path_probe.sass_loops: each backward branch's body, from its
    target to the branch, with its opcodes (predicates and modifiers
    dropped), shortest first; a forward branch is no loop."""
    sass = ("\t\tFunction : _ZN12_GLOBAL__N_114whitted_kernelEv\n"
            "        /*0000*/                   MOV R1, c[0x0][0x28] ;\n"
            "        /*0010*/                   LDS.128 R4, [R2] ;\n"
            "        /*0020*/                   FFMA R5, R4, R6, R7 ;\n"
            "        /*0030*/              @!P0 BRA 0x10 ;\n"
            "        /*0040*/                   FSETP.GT.AND P1, PT, R5, "
            "RZ, PT ;\n"
            "        /*0050*/               @P1 BRA 0x70 ;\n"
            "        /*0060*/                   BRA 0x0 ;\n"
            "        /*0070*/                   EXIT ;\n"
            "\t\tFunction : _ZN12_GLOBAL__N_111other_kernelEv\n"
            "        /*0000*/                   BRA 0x0 ;\n")
    loops = path_probe.sass_loops(sass, "whitted_kernel")
    assert loops == [
        (0x10, 0x30, 3, {"LDS": 1, "FFMA": 1, "BRA": 1}),
        (0x0, 0x60, 7, {"BRA": 3, "MOV": 1, "LDS": 1, "FFMA": 1,
                        "FSETP": 1})]
    assert path_probe.sass_loops(sass, "no_such_kernel") == []


def test_table_whitted_sweep_rewrites_its_constants(tmp_path):
    """Kernel 4 is built for kTableWhittedBlocks resident blocks an SM, a
    constexpr that the probe's sweep rewrites: one copy a value of
    TABLE_WHITTED_BUILDS (6-10), each differing from the source in that
    line alone."""
    from orion_tpu_torch.ops import cuda_build
    from tools import brute_probe

    src = (cuda_build.CSRC / "whitted.cu").read_text()
    assert "__launch_bounds__(kThreads, kTableWhittedBlocks)" in src
    (tmp_path / "whitted.cu").write_text(src)
    copies = path_probe.table_whitted_sweep_sources(tmp_path)
    assert len(copies) == len(path_probe.TABLE_WHITTED_BUILDS) == 5
    for tag, cu in copies.items():
        consts = brute_probe.parse_set(tag)
        out = cu.read_text()
        diff = [(a, c) for a, c in zip(src.splitlines(), out.splitlines())
                if a != c]
        assert len(diff) <= len(consts)
        for name, v in consts.items():
            assert f"constexpr int {name} = {v};" in out
