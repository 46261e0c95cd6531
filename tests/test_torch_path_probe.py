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
