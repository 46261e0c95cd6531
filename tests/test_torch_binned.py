"""The port's binned dense sweep (orion_tpu_torch/ops/binned.py) against
orion_tpu.ops.pallas_binned, on the CPU: the port on its plain versions,
JAX in interpret mode, both on the identical tree (JAX's, handed over with
bvh_from_numpy), table and PCG seed.

Tolerances. Bins and slab entries are equal array for array. A sweep's
winners are equal row for row and t, u, v to rel 1e-5 (the same float32
Woop arithmetic, which XLA may evaluate with fused multiply-adds: one lane
in 512 is 2e-6 apart); a round of the plain version equals the JAX round
kernel's output. Images agree to rtol 1e-5, atol 1e-6 (the JAX package's
own bound for its binned image against its replica). The one standing
difference is the slab test's NaN (a ray with d[a] == 0 in the plane of a
bin flat on that axis), shown by its own case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_binned as jbn
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch.accel.bvh import bvh_from_numpy
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.ops import binned as bn
from orion_tpu_torch.ops import bounce as bo

from cornell_scenes import write_cornell
from torch_port_util import jax_bvh_fields, to_torch

S, D, LS = 2, 2, 2


def _seed(k):
    key = jax.random.key(k)
    return key, int(jf.seed_scalar(key)[0])


class Both:
    """One inline Cornell box (levels 0: 36 triangles, one bin; levels 3:
    2,178 triangles, nine bins) in both packages, with JAX's binned data
    and the port's scene on JAX's tree."""

    def __init__(self, tmp, res, levels):
        rtc = write_cornell(tmp, xres=res, yres=res, depth=D, levels=levels)
        self.js, self.jrtc = jload_scene(rtc)
        self.jcam = jcamera_from_rtc(self.jrtc)
        self.ts = to_torch(self.js)
        self.cam = camera_from_rtc(self.jrtc, device="cpu")
        self.jbins, self.jtab, jbvh = jbn.binned_device_data(self.js)
        self.bvh = bvh_from_numpy(jax_bvh_fields(jbvh))

    def port_data(self, max_rows=bn.MAX_ROWS):
        return bn.binned_device_data(self.ts, max_rows=max_rows,
                                     bvh=self.bvh)


@pytest.fixture(scope="module")
def lv0(tmp_path_factory):
    return Both(tmp_path_factory.mktemp("lv0"), 8, 0)


@pytest.fixture(scope="module")
def lv3(tmp_path_factory):
    return Both(tmp_path_factory.mktemp("lv3"), 8, 3)


@pytest.mark.parametrize("max_rows", [256, 512, 1024])
def test_bins_equal_jax(lv3, max_rows):
    """Equal to JAX's bins on the same tree; they tile the bundled rows
    with no gap, 128-aligned, each within max_rows (no leaf is wider)."""
    jb = jbn.make_bins(jbn.binned_device_data(lv3.js)[2], max_rows)
    bins, tab, bvh = lv3.port_data(max_rows)
    for name in ("lo", "hi", "row0", "n_bundles"):
        np.testing.assert_array_equal(getattr(bins, name),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(lv3.jtab).T)
    assert bins.row0.shape == (bins.k + 1,) and bins.n_bundles[-1] == 0
    spans = sorted(zip(bins.row0[:-1].tolist(),
                       (bins.n_bundles[:-1] * bn.LEAF_WIDTH).tolist()))
    cur = 0
    for r0, rows in spans:
        assert r0 == cur and r0 % bn.LEAF_WIDTH == 0 and 0 < rows <= max_rows
        cur += rows
    assert cur == bvh.num_bundled
    if max_rows == bn.MAX_ROWS:
        assert bins.k == 9


def test_row_gate_and_leaf_width(lv0):
    """2^22 bundled rows or more raise before anything is packed (a
    zero-strided stand-in costs no memory), and so does a tree of another
    leaf width: routing then falls through, as in the JAX package."""
    big = dataclasses.replace(lv0.bvh, tri_v0=np.broadcast_to(
        np.zeros(3, np.float32), (1 << 22, 3)))
    with pytest.raises(ValueError, match="sentinel"):
        bn.binned_device_data(lv0.ts, bvh=big)
    with pytest.raises(ValueError, match="leaf_width"):
        bn.binned_device_data(lv0.ts, bvh=dataclasses.replace(
            lv0.bvh, leaf_width=16))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform((-0.95, 0.05, -0.95), (0.95, 1.95, 0.95),
                    (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.uniform(size=n) > 0.2
    return o, d, alive


@pytest.fixture(scope="module")
def jax_sweep(lv3):
    """JAX's binned sweep (interpret mode) on 512 rays, jitted per mode."""
    n = 512
    consts = jbn.binned_consts(lv3.jbins, lv3.jtab)
    call = jbn.build_bin_round_call(lv3.jbins.k, n, jbn.RAY_BLOCK,
                                    interpret=True)

    def run(mode, o, d, alive):
        @jax.jit
        def f(consts, o, d, alive):
            sw = jbn.binned_sweep_from(consts, k=lv3.jbins.k, n_rays=n,
                                       call=call, ray_block=jbn.RAY_BLOCK)
            o3 = tuple(o[:, c] for c in range(3))
            d3 = tuple(d[:, c] for c in range(3))
            al = None if mode == "nearest" else alive
            if mode == "any-hit":
                return (sw.any_hit(o3, d3, alive=al),)
            cap = jbn._BIG if mode != "capped" else np.float32(1.05)
            t, row = sw.closest(o3, d3, al, cap)[:2]
            out = sw(o3, d3, (22, 29), alive=al,
                     t_init=None if mode != "capped" else 1.05)
            return t, row, *out[:4], out[4][22], out[4][29]
        return [np.asarray(x) for x in f(consts, jnp.asarray(o),
                                         jnp.asarray(d), jnp.asarray(alive))]

    return n, run


@pytest.mark.parametrize("mode", ["nearest", "alive", "capped", "any-hit"])
def test_sweep_matches_jax(lv3, jax_sweep, mode):
    """(t, row) of closest and the sweep's (t, hit, u, v, columns), or the
    any-hit mask, equal JAX's on random rays from inside the box."""
    n, run = jax_sweep
    o, d, alive = _rays(n, 3)
    bins, tab, _ = lv3.port_data()
    sw = bn.BinnedSweep(bins, tab)
    o3 = tuple(torch.as_tensor(o[:, c]) for c in range(3))
    d3 = tuple(torch.as_tensor(d[:, c]) for c in range(3))
    al = None if mode == "nearest" else torch.as_tensor(alive)
    ref = run(mode, o, d, alive)
    if mode == "any-hit":
        hit = sw.any_hit(o3, d3, alive=al)
        np.testing.assert_array_equal(hit.numpy(), ref[0])
        assert 0 < ref[0].sum() < n
        return
    cap = 1.05 if mode == "capped" else bn.BIG
    t, row = sw.closest(o3, d3, al, cap)
    np.testing.assert_array_equal(row.numpy(), ref[1])
    np.testing.assert_allclose(t.numpy(), ref[0], rtol=1e-5)
    t, hit, u, v, got = sw(o3, d3, (22, 29), alive=al,
                           t_init=None if mode != "capped" else 1.05)
    np.testing.assert_array_equal(hit.numpy(), ref[3])
    assert 0 < ref[3].sum() < n
    for ours, theirs in ((t, ref[2]), (u, ref[4]), (v, ref[5]),
                         (got[22], ref[6]), (got[29], ref[7])):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5,
                                   atol=1e-6)
    assert sw.counts["rounds"] >= 2 and int(sw.counts["tests"]) > 0


def test_bin_entries_match_jax_and_slab_nan(lv3):
    """bin_entries equals JAX's _bin_entries on random rays. The standing
    difference: a ray that does not move along x (d.x == 0) lying in the
    plane of a bin flat in x: JAX's min/max propagate 0 * inf = NaN and
    skip the bin, the port's fmin/fmax decide it by the other two axes and
    enter it."""
    o, d, _ = _rays(256, 5)
    bins, _, _ = lv3.port_data()
    lo, hi = torch.as_tensor(bins.lo), torch.as_tensor(bins.hi)
    ours = bn.bin_entries(tuple(torch.as_tensor(o[:, c]) for c in range(3)),
                          tuple(torch.as_tensor(d[:, c]) for c in range(3)),
                          lo, hi)
    theirs = np.asarray(jbn._bin_entries(
        [jnp.asarray(o[:, c]) for c in range(3)],
        [jnp.asarray(d[:, c]) for c in range(3)], jnp.asarray(bins.lo),
        jnp.asarray(bins.hi)))
    np.testing.assert_array_equal(ours.numpy(), theirs)

    # a flat bin (x = 0, as a wall's leaf is at levels 5) and a ray in its
    # plane, moving along neither x nor y: 0 * inf on x
    lo1, hi1 = np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32)
    hi1[0, 0] = 0.0
    o1 = [np.array([v], np.float32) for v in (0.0, 0.5, 2.0)]
    d1 = [np.array([v], np.float32) for v in (0.0, 0.0, -1.0)]
    ours = bn.bin_entries(tuple(map(torch.as_tensor, o1)),
                          tuple(map(torch.as_tensor, d1)),
                          torch.as_tensor(lo1), torch.as_tensor(hi1))
    theirs = np.asarray(jbn._bin_entries([jnp.asarray(x) for x in o1],
                                         [jnp.asarray(x) for x in d1],
                                         jnp.asarray(lo1), jnp.asarray(hi1)))
    assert np.isinf(theirs[0, 0])
    assert float(ours[0, 0]) == 1.0


def test_round_plain_matches_jax_kernel(lv3):
    """One round of the plain version equals JAX's round kernel
    (interpret mode) on lanes sorted by bin, dead lanes keyed K, some lanes
    already holding a hit."""
    n = 512
    o, d, alive = _rays(n, 7)
    bins, tab, _ = lv3.port_data()
    K = bins.k
    rng = np.random.default_rng(8)
    key = np.sort(np.where(alive, rng.integers(0, K, n), K)).astype(np.int32)
    st = np.zeros((16, n), np.float32)
    st[0:3], st[3:6] = o.T, d.T
    st[6] = np.where(rng.uniform(size=n) < 0.3, 1.5, jbn._BIG)
    st[7] = np.where(st[6] < 2.0, 77.0, jbn._NO_ROW)
    st[6] = np.where(key < K, st[6], -jbn._BIG)
    G = n // jbn.RAY_BLOCK
    ks = key.reshape(G, -1)
    blk_lo = ks.min(axis=1)
    blk_hi = np.where(ks < K, ks, -1).max(axis=1)
    bini = np.zeros((8, n), np.int32)
    bini[0] = key
    call = jbn.build_bin_round_call(K, n, jbn.RAY_BLOCK, interpret=True)
    ref = np.asarray(call(jnp.asarray(bins.row0), jnp.asarray(bins.n_bundles),
                          jnp.asarray(blk_lo), jnp.asarray(blk_hi),
                          jnp.asarray(st), jnp.asarray(bini), lv3.jtab))
    ours = bn.binned_round(torch.as_tensor(st[:8]), torch.as_tensor(key),
                           torch.as_tensor(bins.row0),
                           torch.as_tensor(bins.n_bundles), tab)
    np.testing.assert_array_equal(ours.numpy(), ref[:2])
    assert (ours[1] < bn.NO_ROW).sum() > n // 4


def _jax_image(lv, key, max_rows=jbn.MAX_ROWS):
    fn = jbn.make_binned_path_renderer(lv.js, lv.jcam, samples=S,
                                       max_depth=D, light_samples=LS,
                                       max_rows=max_rows, interpret=True)
    return np.asarray(fn(key))


@pytest.mark.parametrize("levels", [0, 3])
def test_image_matches_jax(lv0, lv3, levels):
    """The binned renderer's image equals JAX's for the same seed."""
    lv = lv0 if levels == 0 else lv3
    key, seed = _seed(3 + levels)
    fn = bn.make_binned_path_renderer(lv.ts, lv.cam, samples=S, max_depth=D,
                                      light_samples=LS, bvh=lv.bvh)
    ours = fn(seed).numpy()
    ref = _jax_image(lv, key)
    assert np.isfinite(ours).all() and ours.mean() > 0
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    c = fn.sweep.counts
    assert c["sweeps"] >= 2 * (D + 1) and c["rounds"] >= c["sweeps"]
    # the bounce pipeline's reference render: the same image
    np.testing.assert_allclose(
        ours, bo.bounce_reference_render(lv.ts, lv.cam, seed, samples=S,
                                         max_depth=D,
                                         light_samples=LS).numpy(),
        rtol=1e-5, atol=1e-6)


def test_image_independent_of_max_rows(lv3):
    """The bin cut is a traversal order, not an estimator change: 256- and
    1024-row bins give the same image."""
    _, seed = _seed(5)
    imgs = [bn.make_binned_path_renderer(
        lv3.ts, lv3.cam, samples=S, max_depth=D, max_rows=m,
        bvh=lv3.bvh)(seed).numpy() for m in (256, 1024)]
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-5, atol=1e-6)


def test_renderer_gates(lv0, tmp_path):
    """Textured scenes and a second light sample count outside the
    standalone vis kernel still render: every site's visibility comes
    from the binned sweep."""
    from torch_port_util import write_textured
    from orion_tpu_torch.scene import load_scene

    tex = load_scene(write_textured(tmp_path), device="cpu")[0]
    with pytest.raises(ValueError, match="gate"):
        bn.make_binned_path_renderer(tex, lv0.cam, samples=1, max_depth=1)
    _, seed = _seed(2)
    for ls in (1, 3):
        img = bn.make_binned_path_renderer(
            lv0.ts, lv0.cam, samples=1, max_depth=1, light_samples=ls,
            bvh=lv0.bvh)(seed)
        ref = bo.bounce_reference_render(lv0.ts, lv0.cam, seed, samples=1,
                                         max_depth=1, light_samples=ls)
        np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6)
