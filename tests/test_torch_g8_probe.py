"""The probes and A/B cases of kernels 11 and 6b on the CPU: G8's counter
report (tools/bvh_probe.py --g8), its sweep's source copies, 6b's counter
report, bounds and per-bounce table (tools/bounce_probe.py --vis), the
planes comparison of tools/bounce_ab.py and the `--cases` arguments of
tools/walk_ab.py and tools/bounce_ab.py."""

import os

import pytest
import torch

from orion_tpu_torch.ops import cuda_build
from tools import bounce_ab, bounce_probe, bvh_probe, walk_ab


def test_g8_report_ratios():
    c = dict(groups=4, live_lanes=100, steps=480, leaves=60, leaf_lanes=150,
             row_tests=25600, cycles=1000, leaf_cycles=400)
    r = bvh_probe.g8_report(c)
    assert (r["groups"], r["live"], r["steps"], r["leaves"]) == (
        4, 25.0, 120.0, 15.0)
    assert r["need"] == pytest.approx(2.5)
    assert r["tests"] == pytest.approx(256.0)
    assert r["leaf_share"] == pytest.approx(0.4)
    zero = bvh_probe.g8_report(dict.fromkeys(c, 0))
    assert zero["live"] == zero["need"] == zero["leaf_share"] == 0.0


def test_g8_sweep_rewrites_one_constant(tmp_path):
    """--g8 --sweep: copies of csrc/bvh_g8.cu, each differing from it in
    one constexpr line; a constant the source lacks is left out."""
    src = cuda_build.CSRC / "bvh_g8.cu"
    text = src.read_text().splitlines()
    sweep = {**bvh_probe.G8_SWEEP, "kNoSuchConstant": (1, 2)}
    paths = bvh_probe.walk_sources(src, tmp_path, sweep=sweep)
    assert len(paths) == sum(len(v) for v in bvh_probe.G8_SWEEP.values())
    assert not any(t.startswith("kNoSuchConstant") for t in paths)
    for tag, path in paths.items():
        assert path.name.startswith("bvh_g8_")
        name, value = tag.split("=")
        diff = [(a, b) for a, b in zip(text, path.read_text().splitlines())
                if a != b]
        assert len(diff) <= 1
        assert f"constexpr int {name} = {value};" in path.read_text()


def _vis_counters(rays, entries, entry_lanes, iters, iter_lanes, steps,
                  tests):
    c = dict.fromkeys(bounce_probe.COUNTERS, 0)
    c.update(shadow_rays=rays, shadow_entries=entries,
             shadow_entry_lanes=entry_lanes, shadow_iters=iters,
             shadow_iter_lanes=iter_lanes, shadow_steps=steps,
             shadow_tests=tests)
    return c


def test_vis_report_and_bounds():
    c = _vis_counters(50, 4, 64, 100, 2400, 2400, 400)
    r = bounce_probe.vis_report(c, 100)
    assert r["walked"] == pytest.approx(0.5)
    assert r["entry"] == pytest.approx(0.5)
    assert r["simt"] == pytest.approx(0.75)
    assert (r["steps"], r["tests"]) == (48.0, 8.0)
    assert bounce_probe.vis_report(dict.fromkeys(bounce_probe.COUNTERS, 0),
                                   0)["simt"] == 0.0
    from chip_smoke import SLAB_TEST_FLOPS, WOOP_TEST_FLOPS, bound_ms

    b = bounce_probe.vis_bounds([c, c], [100, 10], 1000)
    assert b[0] == pytest.approx(bound_ms(
        2400 * SLAB_TEST_FLOPS + 400 * WOOP_TEST_FLOPS,
        100 * 22 * 4 + 1000)[0])
    assert b[1] < b[0]


def test_vis_lines_sum_the_bounces():
    split = {("vis", 0): (10, 2.0), ("shade", 0): (10, 1.0),
             ("vis", 1): (4, 0.5), ("shade", 1): (4, 0.25)}
    fused = {("shade", 0): (10, 4.0), ("shade", 1): (4, 1.5)}
    lines = bounce_probe.vis_lines(split, fused)
    assert lines[1] == "0 | 10 | 2.000 | 1.000 | 4.000"
    assert lines[3] == "sum | 14 | 2.500 | 1.250 | 5.500"
    assert lines[4] == ("vis + shade given vis 3.750 ms against the fused "
                        "shade 5.500 a render; depth 0 3.000 against 4.000")


def test_compare_vis_counts_lanes_by_bounce():
    a = [torch.zeros(2, 5), torch.ones(2, 3)]
    b = [torch.zeros(2, 5), torch.ones(2, 3)]
    b[1][1, 2] = 0.0
    assert bounce_ab.compare_vis(a, b) == [
        "6b planes depth 0: 0 of 5 lanes differ",
        "6b planes depth 1: 1 of 3 lanes differ"]
    assert bounce_ab.compare_vis(a, b[:1]) == ["6b planes: 2 / 1 bounces"]


@pytest.mark.parametrize("tool", [walk_ab, bounce_ab])
def test_ab_cases_arguments(tool, monkeypatch, capsys):
    """--cases takes a comma list of the tool's CASES into the runs'
    environment; an unknown or missing case prints the doc and returns 2."""
    seen = []
    monkeypatch.setattr(tool, "ab_main", lambda argv, *a, **k: seen.append(
        (list(argv), os.environ.get(tool.CASES_ENV))) or 0)
    monkeypatch.delenv(tool.CASES_ENV, raising=False)
    assert tool.main(["OLD", "NEW", "--cases", tool.CASES[-1]]) == 0
    assert seen == [(["OLD", "NEW"], tool.CASES[-1])]
    assert tool.main(["OLD", "NEW", "--cases", "nope"]) == 2
    assert tool.main(["OLD", "NEW", "--cases"]) == 2
    assert "--cases" in capsys.readouterr().err
