"""tools/bounce_probe.py's host arithmetic on the CPU (the probe itself needs
a card), tools/bounce_ab.py's hitdata comparison, tools/sass_diff.py's
kernel list and what the A/B tools share (tools/ab_turns.py): the numbers
that PERF.md takes from them are these formulas."""

import pytest
import torch

from tools import ab_turns, bounce_ab, bounce_probe, sass_diff
from orion_tpu_torch.ops import cuda_build


def _counters(**kw):
    c = dict.fromkeys(bounce_probe.COUNTERS, 0)
    c.update(kw)
    return c


def test_walk_report_means_and_simt():
    """A ray's mean steps and tests; SIMT = active lanes summed over warp
    iterations / (32 x iterations)."""
    c = _counters(walk_rays=64, walk_steps=640, walk_tests=256,
                  walk_iters=40, walk_iter_lanes=640, walk_warps=2)
    r = bounce_probe.walk_report(c)
    assert r == dict(rays=64, steps=10.0, tests=4.0, simt=0.5)


def test_shade_report_shares():
    """Cycle shares of draws, shadow walk and the rest; the share of lanes
    that walk; a warp entry's active lanes and the walk loop's SIMT; a
    pair's steps and tests."""
    c = _counters(shade_lanes=128, shade_cycles=10_000, draw_cycles=1_500,
                  shadow_cycles=7_000, shadow_rays=48, shadow_entries=4,
                  shadow_entry_lanes=48, shadow_iters=100,
                  shadow_iter_lanes=1600, shadow_steps=960,
                  shadow_tests=384, shade_warps=4)
    r = bounce_probe.shade_report(c)
    assert r["lanes"] == 128
    assert r["draw"] == pytest.approx(0.15)
    assert r["shadow"] == pytest.approx(0.70)
    assert r["rest"] == pytest.approx(0.15)
    assert r["walked"] == pytest.approx(0.375)
    assert r["entry"] == pytest.approx(0.375)
    assert r["simt"] == pytest.approx(0.5)
    assert r["steps"] == 20.0 and r["tests"] == 8.0


@pytest.mark.parametrize("report", [bounce_probe.walk_report,
                                    bounce_probe.shade_report])
def test_reports_of_empty_counters(report):
    """A launch with nothing counted (a bounce with no live lane) gives
    zeros, not a division by zero."""
    assert all(v == 0 for v in report(_counters()).values())


def test_add_counters_sums_launches():
    a = _counters(walk_rays=3, shade_cycles=10)
    b = _counters(walk_rays=4, shadow_rays=2)
    s = bounce_probe.add_counters([a, b])
    assert s["walk_rays"] == 7 and s["shade_cycles"] == 10
    assert s["shadow_rays"] == 2 and set(s) == set(bounce_probe.COUNTERS)


def test_per_bounce_table_from_stage_medians():
    """The medians over runs per (stage, depth), then lanes and both
    kernels' times per depth and their sums."""
    runs = [[("walk", 0, 100, 2.0), ("shade", 0, 100, 5.0),
             ("walk", 1, 40, 1.0), ("shade", 1, 40, 3.0),
             ("sort", 1, 100, 9.0)],
            [("walk", 0, 100, 4.0), ("shade", 0, 100, 7.0),
             ("walk", 1, 40, 2.0), ("shade", 1, 40, 1.0),
             ("sort", 1, 100, 9.0)],
            [("walk", 0, 100, 3.0), ("shade", 0, 100, 6.0),
             ("walk", 1, 40, 3.0), ("shade", 1, 40, 2.0),
             ("sort", 1, 100, 9.0)]]
    stages = bounce_probe.stage_medians(runs)
    assert stages[("walk", 0)] == (100, 3.0)
    assert stages[("shade", 1)] == (40, 2.0)
    lines = bounce_probe.per_bounce_lines(stages)
    assert lines[1] == "0 | 100 | 3.000 | 6.000"
    assert lines[2] == "1 | 40 | 2.000 | 2.000"
    assert lines[-1] == "sum | 140 | 5.000 | 8.000"


def test_step_split():
    """Forward = the pipeline's stages; the rest = step - forward -
    adjoints."""
    stages = {("primaries", 0): (8, 1.0), ("walk", 0): (8, 2.0),
              ("shade", 0): (8, 3.0), ("sort", 1): (8, 0.5),
              ("cotangent", 0): (8, 0.25), ("adjoints", 0): (8, 1.5)}
    s = bounce_probe.step_split(stages, 10.0)
    assert s == dict(step=10.0, forward=6.5, adjoints=1.5, rest=2.0)


def test_render_bounds_sum_launches():
    """Per launch the larger of bytes / 3.35 TB/s and operations / 67
    TFLOP/s, summed over the bounces; 6b and 6c share the shadow work."""
    w = _counters(walk_steps=10**9, walk_tests=10**8)
    sh = _counters(shadow_steps=2 * 10**9, shadow_tests=10**8)
    b = bounce_probe.render_bounds([w, w], [sh, sh], [10**6, 10**3], 0)
    walk_ops = (10**9 * 12 + 10**8 * 39) / 67e12 * 1e3
    shadow_ops = (2 * 10**9 * 12 + 10**8 * 39) / 67e12 * 1e3
    assert b["walk"] == pytest.approx(2 * walk_ops)
    assert b["vis"] == pytest.approx(2 * shadow_ops)
    assert b["shade"] == pytest.approx(2 * shadow_ops)
    # no work: the bytes bound it
    e = _counters()
    b = bounce_probe.render_bounds([e], [e], [10**6], 10**6)
    assert b["walk"] == pytest.approx((10**6 * 60 + 10**6) / 3.35e12 * 1e3)
    assert b["shade"] == pytest.approx((10**6 * 140 + 10**6) / 3.35e12
                                       * 1e3)


def test_compare_hitdata_counts_lanes_by_row():
    a = torch.zeros((5, 6))
    a[0] = torch.tensor([1.0, 2.0, 3.0, 1e30, 5.0, 6.0])
    a[3] = torch.tensor([4.0, 5.0, 6.0, 0.0, 7.0, 8.0])
    a[4] = torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    b = a.clone()
    assert bounce_ab.compare_hitdata(a, b)[0] == ("depth 0 hitdata: 0 of 6 "
                                                  "lanes differ")
    b[1, 2] = 0.25          # u of one lane
    b[3, 4] = 9.0           # another lane's winner
    lines = bounce_ab.compare_hitdata(a, b)
    assert lines[0] == "depth 0 hitdata: 2 of 6 lanes differ"
    assert "  u: 1 lanes, largest |difference| 0.25" in lines
    assert lines[-1].endswith("winners differ where both hit 1")


def test_sass_diff_keeps_every_untouched_kernel():
    """The kernels a redesign of other kernels must leave alone: 1, 3a,
    3b, 5, 8, 9a, 9b, 6a, the draw kernel of 6b's launch entry and 6c (2,
    4, 7a, 7b, 10, 11 and 6b's vis kernel, redesigned since, are not among
    them); more are named as source:kernel[:also]."""
    names = {(s, k) for s, k, _ in sass_diff.KERNELS}
    assert not names & {("whitted", "whitted_kernel"),
                        ("binned", "binned_round_kernel"),
                        ("bvh_g8", "bvh_g8_kernel"),
                        ("bounce", "bounce_vis_kernel")}
    for want in (("fused_path", "fused_path_kernel"),
                 ("prb", "17prb_fwd_ls_kernel"),
                 ("prb", "17prb_replay_kernel"),
                 ("bvh_intersect", "bvh_intersect_kernel"),
                 ("bvh_path", "bvh_path_kernel"),
                 ("prb", "bvh_prb_fwd_kernel"),
                 ("prb", "bvh_prb_replay_kernel"),
                 ("bounce", "bounce_walk_kernel"),
                 ("bounce", "bounce_draw_kernel"),
                 ("bounce", "bounce_shade_kernel")):
        assert want in names
    more = sass_diff.parse_kernels(["bounce:bounce_shade_kernel:Lb0ELb0E"])
    assert more[-1] == ("bounce", "bounce_shade_kernel", ("Lb0ELb0E",))
    assert more[:-1] == sass_diff.KERNELS


@pytest.mark.parametrize("name", sorted(bounce_probe.SWEEP))
def test_sweep_rewrites_one_constant(name):
    """--sweep builds copies of csrc/bounce.cu with one constexpr set to
    each of its values; the source defines each exactly once, and the copy
    differs from it in that line alone."""
    src = (cuda_build.CSRC / "bounce.cu").read_text()
    for v in bounce_probe.SWEEP[name]:
        out = bounce_probe.with_constant(src, name, v)
        diff = [(a, b) for a, b in zip(src.splitlines(), out.splitlines())
                if a != b]
        assert len(out.splitlines()) == len(src.splitlines())
        assert len(diff) <= 1
        assert f"constexpr int {name} = {v};" in out
    with pytest.raises(ValueError, match="0 definitions"):
        bounce_probe.with_constant(src, "kNoSuchConstant", 1)


def test_ab_main_runs_in_turns(monkeypatch, capsys):
    """OLD NEW runs `--one` in the order old, new, new, old, each in a
    process of its own; the first run of each version gets the directory
    that keep() reads afterwards; `--one` calls the tool's own timing;
    anything else prints the usage."""
    calls, kept = [], []
    monkeypatch.setattr(ab_turns, "card", lambda *a: "card, 700.00 W")
    monkeypatch.setattr(ab_turns.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd[1:]))
    assert ab_turns.ab_main(["A", "B"], "doc", "tool.py", None,
                            keep=kept.append) == 0
    assert [c[:4] for c in calls] == [["tool.py", "--one", "A", "old-1"],
                                      ["tool.py", "--one", "B", "new-1"],
                                      ["tool.py", "--one", "B", "new-2"],
                                      ["tool.py", "--one", "A", "old-2"]]
    assert [len(c) for c in calls] == [5, 5, 4, 4]
    assert calls[0][4] == calls[1][4] == str(kept[0])
    assert capsys.readouterr().out.splitlines()[0] == "card, 700.00 W"
    seen = []
    assert ab_turns.ab_main(["--one", "A", "old-1"], "doc", "tool.py",
                            lambda *a: seen.append(a)) == 0
    assert seen == [("A", "old-1")]
    assert ab_turns.ab_main(["A"], "usage", "tool.py", None) == 2
    assert "usage" in capsys.readouterr().err


def test_red_wall_scales_the_reddest_albedo(tmp_path):
    """The train problem's perturbation: the reddest mesh's albedo x 0.6,
    the other meshes and the scene's own table untouched."""
    from cornell_scenes import write_cornell
    from orion_tpu_torch.scene import load_scene

    sc, _ = load_scene(write_cornell(tmp_path, xres=8, yres=8),
                       device="cpu")
    kd, pert = ab_turns.red_wall(sc)
    red = int(torch.argmax(sc.mat_diffuse[:, 0] - sc.mat_diffuse[:, 1]))
    assert sc.mat_diffuse[red, 0] > sc.mat_diffuse[red, 1]
    assert torch.equal(kd[red], sc.mat_diffuse[red] * 0.6)
    others = torch.arange(kd.shape[0]) != red
    assert torch.equal(kd[others], sc.mat_diffuse[others])
    assert pert.mat_diffuse is kd and pert.tri_v0 is sc.tri_v0


def test_ab_tools_share_the_driver():
    """The A/B tools' main() is ab_turns.ab_main: no copy of the turn
    order or the nvidia-smi query is left in them."""
    from pathlib import Path

    for tool in ("bounce_ab", "prb_ab", "fused_ab"):
        text = (Path(ab_turns.__file__).parent / f"{tool}.py").read_text()
        assert "ab_main(" in text and "nvidia-smi" not in text
        assert '"old-1"' not in text
