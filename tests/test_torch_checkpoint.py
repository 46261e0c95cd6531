"""The port's host services: resumable accumulation (io/checkpoint.py),
profiling.trace, and the CLI's --checkpoint and --normal-maps, on the CPU
(the span registry: tests/test_torch_tracing.py).

Resume cases follow the JAX package's (tests/test_engine_cli.py): an
interrupted and resumed accumulation equals a one-shot one (rtol 1e-5,
atol 1e-6); a different seed or configuration restarts; a regen
accumulation resumes with the same `every`.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from orion_tpu_torch import cli, profiling
from orion_tpu_torch.engine import prepare
from orion_tpu_torch.io.checkpoint import (_progress_line, load_checkpoint,
                                           render_accumulate,
                                           save_checkpoint)
from orion_tpu_torch.io.image import load_hdr

import torch_port_util  # noqa: F401  (one intra-op thread a worker)
from cornell_scenes import write_cornell, write_cornell_whitted

PATH = dict(light_samples=1, max_depth=2, mode="path", progress=False)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    rtc = write_cornell(tmp_path_factory.mktemp("ck"), xres=16, yres=12,
                        depth=3)
    return prepare(rtc, device="cpu")


def test_checkpoint_resume_matches_oneshot(cornell, tmp_path):
    oneshot = render_accumulate(cornell, 3, samples=4,
                                path=tmp_path / "a.ckpt", every=4, **PATH)
    p = tmp_path / "b.ckpt"
    # chunked by a smaller `every`, "interrupted" after the first flush
    render_accumulate(cornell, 3, samples=2, path=p, every=2, **PATH)
    ck = load_checkpoint(p)
    assert ck is not None and ck[1] == 2 and ck[2] == 3
    assert "device=cpu" in ck[4] and ck[3].dtype == np.uint8
    resumed = render_accumulate(cornell, 3, samples=4, path=p, every=2,
                                **PATH)
    assert load_checkpoint(p)[1] == 4
    assert np.isfinite(oneshot).all() and oneshot.mean() > 0
    np.testing.assert_allclose(resumed, oneshot, rtol=1e-5, atol=1e-6)
    # every size of chunk draws the same stream: 1 + 3 too
    q = tmp_path / "c.ckpt"
    render_accumulate(cornell, 3, samples=1, path=q, every=1, **PATH)
    np.testing.assert_allclose(
        render_accumulate(cornell, 3, samples=4, path=q, every=3, **PATH),
        oneshot, rtol=1e-5, atol=1e-6)


def test_checkpoint_ignores_mismatched_seed(cornell, tmp_path):
    p = tmp_path / "c.ckpt"
    render_accumulate(cornell, 1, samples=2, path=p, every=2, **PATH)
    # a different seed restarts, and overwrites
    img2 = render_accumulate(cornell, 2, samples=2, path=p, every=2, **PATH)
    fresh = render_accumulate(cornell, 2, samples=2,
                              path=tmp_path / "d.ckpt", every=2, **PATH)
    np.testing.assert_allclose(img2, fresh, rtol=1e-6)
    assert load_checkpoint(p)[2] == 2


def test_checkpoint_rejects_mismatched_config(cornell, tmp_path):
    p = tmp_path / "cfg.ckpt"
    render_accumulate(cornell, 5, samples=2, path=p, every=2, **PATH)
    # same seed, another depth: the depth-2 accumulation is not resumed
    kw = dict(PATH, max_depth=3)
    img = render_accumulate(cornell, 5, samples=2, path=p, every=2, **kw)
    fresh = render_accumulate(cornell, 5, samples=2,
                              path=tmp_path / "f.ckpt", every=2, **kw)
    np.testing.assert_allclose(img, fresh, rtol=1e-6)
    assert "max_depth=3" in load_checkpoint(p)[4]


def test_checkpoint_regen_resume(cornell, tmp_path):
    kw = dict(light_samples=1, max_depth=3, mode=None, regen=True,
              progress=False)
    oneshot = render_accumulate(cornell, 5, samples=4,
                                path=tmp_path / "r.ckpt", every=2, **kw)
    p = tmp_path / "s.ckpt"
    render_accumulate(cornell, 5, samples=2, path=p, every=2, **kw)
    assert load_checkpoint(p)[1] == 2
    resumed = render_accumulate(cornell, 5, samples=4, path=p, every=2, **kw)
    assert np.isfinite(oneshot).all() and oneshot.mean() > 0
    np.testing.assert_allclose(resumed, oneshot, rtol=1e-5, atol=1e-6)


def test_checkpoint_regen_rejects_whitted_and_saves_atomically(tmp_path):
    ps = prepare(write_cornell_whitted(tmp_path, xres=8, yres=8), device="cpu")
    with pytest.raises(ValueError, match="path-mode only"):
        render_accumulate(ps, 0, samples=1, light_samples=1, max_depth=1,
                          mode=None, path=tmp_path / "w.ckpt", regen=True)
    p = tmp_path / "x.ckpt"
    state = torch.Generator().get_state().numpy()
    save_checkpoint(p, np.ones((2, 2, 3), np.float32), 7, 11, state, "cfg")
    accum, done, seed, rng, config = load_checkpoint(p)
    assert done == 7 and seed == 11 and config == "cfg"
    assert np.array_equal(rng, state) and accum.sum() == 12
    assert sorted(x.name for x in tmp_path.iterdir()
                  if x.suffix == ".tmp") == []
    assert load_checkpoint(tmp_path / "absent.ckpt") is None


def test_progress_lines(cornell, tmp_path, capsys):
    line = _progress_line(4, 8, 2_000_000, 0.5, 0, 1.0)
    assert line.startswith("[render] 4/8 spp") and "4.00M primary" in line
    assert "ETA 1s" in line
    render_accumulate(cornell, 0, samples=3, path=tmp_path / "p.ckpt",
                      every=2, light_samples=1, max_depth=1, mode="path")
    err = capsys.readouterr().err.splitlines()
    assert [ln.split()[1] for ln in err] == ["2/3", "3/3"]


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64).sum()
    data = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert data["traceEvents"]


def _cli(argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(argv) == 0
    return err.getvalue()


def test_cli_normal_maps_take_the_wavefront(tmp_path):
    rtc = write_cornell(tmp_path, xres=12, yres=8, depth=2, bump=True)
    base = [str(rtc), "-p", "2", "-l", "1", "--device", "cpu", "--stats"]
    err = _cli(base + ["-o", str(tmp_path / "n.hdr"), "--normal-maps"])
    assert json.loads(err.splitlines()[-1])["backend"] == "brute-kernel"
    err = _cli(base + ["-o", str(tmp_path / "f.hdr"), "--backend", "brute"])
    assert json.loads(err.splitlines()[-1])["backend"] == "brute-kernel"
    bumped, flat = load_hdr(tmp_path / "n.hdr"), load_hdr(tmp_path / "f.hdr")
    assert np.isfinite(bumped).all() and bumped.mean() > 0
    assert np.abs(bumped - flat).max() > 1e-3
    # --backend fused --normal-maps pins the megakernel, as in JAX (on the
    # box without its bump map: a map leaves the fused gate)
    plain = write_cornell(tmp_path / "plain", xres=12, yres=8, depth=2)
    err = _cli([str(plain)] + base[1:] + ["-o", str(tmp_path / "m.hdr"),
                                          "--normal-maps", "--backend",
                                          "fused"])
    assert json.loads(err.splitlines()[-1])["backend"] == "fused-kernel"
    with pytest.raises(SystemExit, match="--normal-maps"):
        cli.main(base + ["-o", str(tmp_path / "r.hdr"), "--normal-maps",
                         "--regen"])


def test_cli_checkpoint_resumes(tmp_path):
    rtc = write_cornell(tmp_path, xres=12, yres=8, depth=2)
    ck = tmp_path / "r.ckpt"
    base = [str(rtc), "-l", "1", "--device", "cpu", "--seed", "4"]
    err = _cli(base + ["-o", str(tmp_path / "a.hdr"), "-p", "2",
                       "--checkpoint", str(ck), "--checkpoint-every", "2"])
    assert "[render] 2/2 spp" in err and load_checkpoint(ck)[1] == 2
    err = _cli(base + ["-o", str(tmp_path / "b.hdr"), "-p", "4",
                       "--checkpoint", str(ck), "--checkpoint-every", "2"])
    assert "[render] 4/4 spp" in err and "2/4" not in err
    _cli(base + ["-o", str(tmp_path / "c.hdr"), "-p", "4", "--checkpoint",
                 str(tmp_path / "one.ckpt"), "--checkpoint-every", "4"])
    # the accumulations in float32 (the .hdr files round to 8-bit
    # mantissas)
    resumed = load_checkpoint(ck)[0] / 4.0
    oneshot = load_checkpoint(tmp_path / "one.ckpt")[0] / 4.0
    assert oneshot.mean() > 0 and load_hdr(tmp_path / "b.hdr").mean() > 0
    np.testing.assert_allclose(resumed, oneshot, rtol=1e-5, atol=1e-6)
    err = _cli(base + ["-o", str(tmp_path / "g.hdr"), "-p", "2", "--regen",
                       "--checkpoint", str(tmp_path / "g.ckpt")])
    assert "regen=True" in load_checkpoint(tmp_path / "g.ckpt")[4]
    # --shard without torchrun is a world of one: the same tag, so the
    # finished accumulation resumes and renders nothing more
    err = _cli(base + ["-o", str(tmp_path / "s.hdr"), "-p", "4", "--shard",
                       "--checkpoint", str(ck), "--checkpoint-every", "2"])
    assert "[render]" not in err and load_checkpoint(ck)[1] == 4
    np.testing.assert_array_equal(load_checkpoint(ck)[0] / 4.0, resumed)


def _jax_format_file(path, shape):
    """A checkpoint as the JAX package writes one (io/checkpoint.py there):
    accum, samples_done, key_data, config; none of the port's seed and
    rng_state."""
    np.savez(path, accum=np.full(shape, 9.0, np.float32),
             samples_done=np.int64(2),
             key_data=np.array([0, 4], np.uint32),
             config=np.str_("mode=path;max_depth=2;light_samples=1;"
                            "regen=False"))
    assert load_checkpoint(path) is None


def test_checkpoint_over_a_jax_format_file_starts_over(cornell, tmp_path):
    p = tmp_path / "jax.ckpt"
    _jax_format_file(p, (12, 16, 3))
    img = render_accumulate(cornell, 3, samples=4, path=p, every=2, **PATH)
    oneshot = render_accumulate(cornell, 3, samples=4,
                                path=tmp_path / "one.ckpt", every=4, **PATH)
    np.testing.assert_allclose(img, oneshot, rtol=1e-5, atol=1e-6)
    with np.load(p) as z:
        assert {"seed", "rng_state", "config"} <= set(z.files)
        assert "key_data" not in z.files
    accum, done, seed, _, config = load_checkpoint(p)
    assert done == 4 and seed == 3 and "device=cpu" in config
    np.testing.assert_allclose(accum / 4.0, oneshot, rtol=1e-5, atol=1e-6)


def test_cli_checkpoint_over_a_jax_format_file_starts_over(tmp_path):
    rtc = write_cornell(tmp_path, xres=12, yres=8, depth=2)
    p = tmp_path / "jax.ckpt"
    _jax_format_file(p, (8, 12, 3))
    base = [str(rtc), "-l", "1", "--device", "cpu", "--seed", "4", "-p", "4"]
    err = _cli(base + ["-o", str(tmp_path / "a.hdr"), "--checkpoint",
                       str(p), "--checkpoint-every", "2"])
    assert "[render] 2/4 spp" in err and "[render] 4/4 spp" in err
    _cli(base + ["-o", str(tmp_path / "b.hdr"), "--checkpoint",
                 str(tmp_path / "one.ckpt"), "--checkpoint-every", "4"])
    ours, one = load_checkpoint(p), load_checkpoint(tmp_path / "one.ckpt")
    assert ours is not None and ours[1] == 4 and ours[2] == 4
    np.testing.assert_allclose(ours[0], one[0], rtol=1e-5, atol=1e-6)
    assert load_hdr(tmp_path / "a.hdr").mean() > 0
