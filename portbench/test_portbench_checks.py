"""CPU tests of the check that decides `correct`: the reference's own
parts, the control (the reference in bfloat16 in the program's place) and
each fault a cell can have, planted in the program's timed path."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import calibrate  # noqa: E402
import harness  # noqa: E402
import reference  # noqa: E402
import scenegen  # noqa: E402

RENDER = dict(xres=16, yres=12, samples=4, max_depth=3,
              check={"pixels": 64, "renders": 3})
FIT = dict(xres=16, yres=12, samples=2, max_depth=3, steps=4,
           check={"steps": 3, "chunk_pixels": 64})


def limit(cell, name):
    return harness.Cell(cell).limits[name]


@pytest.fixture(scope="module")
def box_l1(tmp_path_factory):
    rtc = scenegen.write_cornell(tmp_path_factory.mktemp("l1"), xres=8,
                                 yres=6, depth=3, levels=1)
    return reference.load_scene(rtc)


def test_scene_files_parse(box_l1):
    assert box_l1.num_triangles == 34 * 4 + 2
    assert len(box_l1.emitters) == 1
    m, first, count = box_l1.emitters[0]
    assert box_l1.mesh_names[m] == "light" and count == 2
    np.testing.assert_allclose(box_l1.ke[m], [17.0, 12.0, 4.0])


def test_tree_walk_equals_brute(box_l1):
    rows = torch.as_tensor(reference.woop_rows(box_l1.v0, box_l1.e1,
                                               box_l1.e2))
    brute = reference.Brute(rows)
    tree = reference.RefTree(box_l1, rows)
    g = torch.Generator().manual_seed(0)
    o = torch.rand((4000, 3), generator=g) * torch.tensor([1.8, 1.8, 1.8]) \
        + torch.tensor([-0.9, 0.1, -0.9])
    d = torch.randn((4000, 3), generator=g)
    counts = reference.Counts()
    for cap in (reference.BIG, 0.7):
        tb, rb = brute(o, d, cap)
        tt, rt = tree(o, d, cap, counts)
        assert torch.equal(rb, rt)
        assert torch.equal(tb, tt)
    c = counts.by_kind["nearest"]
    # the walk tests far fewer triangles than a sweep of all of them
    assert 0 < c["tri"] < 0.5 * c["segments"] * box_l1.num_triangles
    assert c["box"] > c["segments"]


def test_reference_follows_the_program_pixel_for_pixel():
    # the program's CPU path (the kernel's plain version) against the
    # reference, on every pixel of a tiny image
    res = harness.run_cell("cornell.render-2048spp", 41, 0.0, False,
                           device="cpu", traffic_overrides=dict(
                               RENDER, check={"pixels": 16 * 12,
                                              "renders": 1}))
    assert res["checks"]["bad_px"]["value"] == 0.0


@pytest.mark.parametrize("cell", ["cornell.render-2048spp"])
def test_render_control_fails(cell, tmp_path):
    cfg = harness.Cell(cell).config
    rtc = scenegen.write_cornell(tmp_path, xres=16, yres=12, depth=3,
                                 **cfg["generator"]["args"])
    sc = reference.load_scene(rtc)
    acc = cfg["reference_accel"]
    f32 = reference.Tracer(sc, "cpu", accel=acc)
    bf16 = reference.Tracer(sc, "cpu", dtype=torch.bfloat16, accel=acc)
    pix = torch.arange(0, 16 * 12, 3)
    loop = harness.load_module(HERE / "loops" / "render.py", "loop")
    for seed in (1, 2, 3):
        want = f32.trace(pix, 4, 3, 2, seed).numpy()
        got = bf16.trace(pix, 4, 3, 2, seed).numpy()
        assert loop.bad_pixel_share(got[None], want[None]) > limit(
            cell, "bad_px")


def test_fit_control_fails():
    cell = "cornell.fit-1080p"
    loop = harness.load_module(HERE / "loops" / "fit.py", "loop")
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        rtc = scenegen.write_cornell(d, xres=16, yres=12, depth=3)
        sc = reference.load_scene(rtc)
        tr = dict(harness.Cell(cell).traffic, **FIT)
        f32 = reference.Tracer(sc, "cpu")
        bf16 = reference.Tracer(sc, "cpu", dtype=torch.bfloat16)
        for seed in (5, 6, 7):
            want = loop.fit_reference(f32, tr, seed, seed + 1, 3)
            got = loop.fit_reference(bf16, tr, seed, seed + 1, 3)
            gaps = {
                "loss_gap": max(abs(a - b) / abs(b) for a, b in
                                zip(got["losses"], want["losses"])),
                "grad_gap": loop.norm_gap(got["grad1"], want["grad1"]),
                "change_gap": loop.norm_gap(got["change"], want["change"])}
            assert any(v > limit(cell, k) for k, v in gaps.items()), gaps


def _wrap_fused(monkeypatch, fn):
    import orion_tpu_torch.ops.fused_path as fp

    orig = fp.fused_path
    monkeypatch.setattr(fp, "fused_path",
                        lambda *a, **kw: fn(orig, *a, **kw))


def test_render_fault_half_the_samples(monkeypatch):
    # half of each pixel's samples left out, the mean over the rest
    def half(orig, tab, clo, chi, em, cam, seed, W, H, samples, *rest, **kw):
        return orig(tab, clo, chi, em, cam, seed, W, H, max(1, samples // 2),
                    *rest, **kw)

    _wrap_fused(monkeypatch, half)
    res = harness.run_cell("cornell.render-2048spp", 43, 0.0, False,
                           device="cpu", traffic_overrides=RENDER)
    assert not res["correct"]


def test_render_fault_altered_answer(monkeypatch):
    _wrap_fused(monkeypatch, lambda orig, *a, **kw: orig(*a, **kw) * 1.01)
    res = harness.run_cell("cornell.render-2048spp", 44, 0.0, False,
                           device="cpu", traffic_overrides=RENDER)
    assert not res["correct"]


def test_render_fault_stale_answer(monkeypatch):
    # the renderer hands back its first image whatever the seed
    first = []

    def stale(orig, *a, **kw):
        if not first:
            first.append(orig(*a, **kw))
        return first[0].clone()

    _wrap_fused(monkeypatch, stale)
    res = harness.run_cell("cornell.render-2048spp", 45, 0.3, False,
                           device="cpu", traffic_overrides=RENDER)
    assert res["attempted"] >= 3
    assert not res["correct"]


def test_fit_fault_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    res = harness.run_cell("cornell.fit-1080p", 46, 0.0, False,
                           device="cpu", traffic_overrides=FIT)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_fit_fault_half_the_batch(monkeypatch):
    import orion_tpu_torch.optim as optim

    orig = optim._prb_loss_and_grad

    def half(ps, target, params, *, samples, **kw):
        return orig(ps, target, params, samples=max(1, samples // 2), **kw)

    monkeypatch.setattr(optim, "_prb_loss_and_grad", half)
    res = harness.run_cell("cornell.fit-1080p", 47, 0.0, False,
                           device="cpu", traffic_overrides=FIT)
    assert not res["correct"]


WHITTED = "cornell-whitted.render-256-1spp"
WHITTED_RENDER = dict(xres=16, yres=12, max_depth=2,
                      check={"pixels": 16 * 12, "renders": 2,
                             "online": True})
# the light moved out of the box's open front, so that few shadow rays
# are blocked and mirror chains land on lit walls; the mirror's Ns 0, so
# that pow(0, 0) reaches the image
FRONT_LIGHT = ("L 0 1.8 0.5 255 255 255 2.0", "L 0 1 2.5 255 255 255 2.0")


def _whitted_scene(d, variant: bool, W: int = 32, H: int = 24,
                   depth: int = 100):
    rtc = scenegen.write_cornell_whitted(d, xres=W, yres=H, depth=depth)
    if variant:
        rtc.write_text(rtc.read_text().replace(*FRONT_LIGHT))
        mtl = rtc.with_suffix(".mtl")
        mtl.write_text(mtl.read_text().replace("Ns 20", "Ns 0"))
    return rtc


@pytest.mark.parametrize("variant", [False, True])
def test_whitted_retrace_follows_the_program(tmp_path, variant):
    # the Whitted kernel's plain version against the retrace on every
    # pixel, and the retrace's tests against the plain version's count
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.ops import whitted as wh

    W, H = 32, 24
    rtc = _whitted_scene(tmp_path, variant)
    ps = prepare(rtc, device="cpu")
    args = wh.whitted_args(ps.scene, ps.camera)
    tracer = reference.WhittedTracer(reference.load_scene(rtc), "cpu")
    loop = harness.load_module(HERE / "loops" / "render.py", "loop")
    for seed in (1, 2**31 + 7):
        stats, counts = {}, reference.Counts()
        got = wh.fused_whitted_plain(*args, seed, W, H, 1, 100, True,
                                     stats=stats).numpy()
        want = tracer.trace(torch.arange(W * H), 1, 100, None, seed,
                            counts=counts).numpy()
        assert loop.bad_pixel_share(got, want) == 0.0
        assert stats["tests"] == sum(c["tri"]
                                     for c in counts.by_kind.values())
        assert counts.by_kind["shadow"]["segments"] > 0


def _whitted_other(name, sc):
    if name == "bf16":
        return reference.WhittedTracer(sc, "cpu", dtype=torch.bfloat16)
    return calibrate.WHITTED_FAULTS[name](sc, "cpu")


@pytest.mark.parametrize("name", ["bf16"] + sorted(calibrate.WHITTED_FAULTS))
def test_whitted_control_and_faults_fail(tmp_path, name):
    # the control and each broken rule, in the program's place, fail the
    # cell's limit: on the configuration's scene where it reaches the
    # image at this size, else on the variant
    variant = name in ("no_mirror", "pow00_zero")
    rtc = _whitted_scene(tmp_path, variant)
    sc = reference.load_scene(rtc)
    f32 = reference.WhittedTracer(sc, "cpu")
    other = _whitted_other(name, sc)
    loop = harness.load_module(HERE / "loops" / "render.py", "loop")
    pix = torch.arange(32 * 24)
    for seed in (1, 2, 3):
        want = f32.trace(pix, 1, 100, None, seed).numpy()
        got = other.trace(pix, 1, 100, None, seed).numpy()
        assert loop.bad_pixel_share(got, want) > limit(WHITTED, "bad_px")


def _wrap_whitted(monkeypatch, fn):
    import orion_tpu_torch.ops.whitted as wh

    orig = wh.fused_whitted
    monkeypatch.setattr(wh, "fused_whitted",
                        lambda *a, **kw: fn(orig, *a, **kw))


def test_whitted_cell_passes_and_logs_its_route(capsys):
    res = harness.run_cell(WHITTED, 48, 0.5, False, device="cpu",
                           traffic_overrides=WHITTED_RENDER)
    assert res["correct"] and res["attempted"] >= 3, res["checks"]
    assert "route: fused-whitted-kernel" in capsys.readouterr().err


def test_whitted_fault_altered_answer(monkeypatch):
    _wrap_whitted(monkeypatch, lambda orig, *a, **kw: orig(*a, **kw) * 1.01)
    res = harness.run_cell(WHITTED, 49, 0.0, False, device="cpu",
                           traffic_overrides=WHITTED_RENDER)
    assert not res["correct"]


def test_whitted_fault_stale_answer(monkeypatch):
    # the renderer hands back its first image whatever the seed
    first = []

    def stale(orig, *a, **kw):
        if not first:
            first.append(orig(*a, **kw))
        return first[0].clone()

    _wrap_whitted(monkeypatch, stale)
    res = harness.run_cell(WHITTED, 50, 0.5, False, device="cpu",
                           traffic_overrides=WHITTED_RENDER)
    assert res["attempted"] >= 3
    assert not res["correct"]
