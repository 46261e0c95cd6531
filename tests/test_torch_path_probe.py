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
