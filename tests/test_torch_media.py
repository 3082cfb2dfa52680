"""Constant media and the isotropic material (ROADMAP Queue A #9.4)
through rrt_tpu_torch's forward, against rrt_tpu on the CPU.

cornell_smoke_scene (six quads, a light and two rotated medium boxes of
density 0.01) and scenes.book2.media_scene (spheres under the sky, a
medium sphere inside a glass one and a rotated medium box, built with
the same calls in both packages) at 16x16 or less, depth 8 or less.
rrt_tpu's Pallas kernels run in interpret mode, as
tests/test_megakernel.py runs them. Rules:

  * scene arrays, pack_media and medium_draws bit for bit;
  * geometry: a medium's t within 1e-5 relative of rrt_tpu's (the port
    takes its kernel's arithmetic, its eager geometry divides where the
    kernel multiplies by a reciprocal), the winning medium and family on
    every ray whose two nearest candidates are not within 1e-5 of each
    other;
  * the plain intersect_only gives rrt_tpu's kernel's (fam, idx) on every
    such ray; the plain bounce_steps follows tests/test_torch_queue.py's
    rule; the three drivers agree within 1e-5 and match rrt_tpu's tile
    render by tests/test_torch_slice.py's rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import rrt_tpu.ops.megakernel as jmk
from rrt_tpu import geometry as jgeo
from rrt_tpu import render as jrender
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import Camera as JCamera
from rrt_tpu.camera import generate_rays as jgenerate_rays
from rrt_tpu.scene import SceneBuilder as JBuilder
from rrt_tpu.vec import V3
from rrt_tpu_torch import cli, convert, geometry, render, rng
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.scenes import book2

W = H = 16


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jmk.pl, "pallas_call", interp)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _both(name, w=W, h=H):
    """(rrt_tpu's scene and camera, the port's builder's)."""
    if name == "media":
        return (book2.media_scene(w, h, JBuilder, JCamera),
                book2.media_scene(w, h))
    return jscenes.SCENES[name](w, h), tscenes.SCENES[name](w, h)


def _v3(x):
    return V3(*(jnp.asarray(c) for c in x))


@pytest.mark.parametrize("name", ["cornell_smoke", "media"])
def test_scene_and_pack_match_reference(name):
    """The builder's arrays, flags and camera, rrt_tpu's scene carried
    across (convert) and pack_media equal rrt_tpu's bit for bit."""
    (j_scene, j_cam), (t_scene, t_cam) = _both(name)
    carried = convert.scene_from_numpy(_leaves(j_scene))
    for f in dataclasses.fields(j_scene):
        a, b, c = (getattr(x, f.name) for x in (j_scene, t_scene, carried))
        if isinstance(b, torch.Tensor):
            assert np.asarray(a).dtype == b.numpy().dtype, f.name
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), f.name)
            np.testing.assert_array_equal(c.numpy(), b.numpy(), f.name)
        else:
            assert a == b == c, (f.name, a, b, c)
    for f in dataclasses.fields(j_cam):
        np.testing.assert_array_equal(np.asarray(getattr(j_cam, f.name)),
                                      getattr(t_cam, f.name).numpy())
    np.testing.assert_array_equal(np.asarray(jmk.pack_media(j_scene)),
                                  tmk.pack_media(t_scene).numpy())
    assert t_scene.has_media and t_scene.n_media_active == 2
    assert not t_scene.has_images_on_media
    solids = tmk.pack_solids(t_scene)
    assert solids.n_media == 2 and solids.med24.shape == (8, 24)
    if name == "cornell_smoke":
        assert tscenes.SCENES["cornell_smoke"] is tscenes.cornell_smoke_scene
        assert (t_scene.n_quads_active, t_scene.n_boxes_active,
                t_scene.n_spheres_active) == (6, 0, 0)


def test_medium_draws_match_reference():
    """medium_draws bit for bit, for 1 to 5 media and per-lane bounce
    counters."""
    g = np.random.default_rng(1)
    keys = g.integers(0, 2 ** 32, (2, 256), dtype=np.uint64)
    jk = jnp.asarray(keys.astype(np.uint32))
    tk = torch.from_numpy(keys.astype(np.int64))
    bounce = g.integers(0, 50, 256)
    for n in range(1, 6):
        for b in (0, 7, bounce):
            ref = np.asarray(jrng.medium_draws(jk, jnp.asarray(b), n))
            got = rng.medium_draws(tk, torch.as_tensor(b), n).numpy()
            np.testing.assert_array_equal(got, ref)


def _rays(name, j_scene, j_cam, kind, n=2048, seed=0):
    """(o, d) (3, n) float32: camera rays, or random rays from inside the
    scene's bounds."""
    if kind == "camera":
        ids = np.arange(n)
        px, py = ids % W, (ids // W) % H
        keys = jrng.sample_keys(jax.random.key(seed),
                                jnp.asarray(py * W + px, jnp.uint32), 0)
        o, d, _ = jgenerate_rays(j_cam, jnp.asarray(px), jnp.asarray(py), W,
                                 H, keys)
        return (np.stack([np.asarray(c) for c in o]).astype(np.float32),
                np.stack([np.asarray(c) for c in d]).astype(np.float32))
    g = np.random.default_rng(seed)
    lo, hi = (5.0, 550.0) if name == "cornell_smoke" else (-3.0, 3.0)
    o = g.uniform(lo, hi, (3, n)).astype(np.float32)
    if name == "media":
        o[1] = np.abs(o[1])
    d = g.standard_normal((3, n)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("kind", ["random", "camera"])
@pytest.mark.parametrize("name", ["cornell_smoke", "media"])
def test_medium_geometry_matches_reference(name, kind):
    """intersect_media, and the media merged with the solids
    (merge_solid_medium through intersect_all) and make_hit's medium
    branch, against rrt_tpu.geometry's on the same draws."""
    (j_scene, j_cam), (t_scene, _) = _both(name)
    o, d = _rays(name, j_scene, j_cam, kind)
    n = o.shape[1]
    u = np.random.default_rng(2).uniform(0, 1, (2, n)).astype(np.float32)
    to, td, tu = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(u)
    tmin, tmax = np.full(n, 1e-3, np.float32), np.full(n, 3e38, np.float32)
    jt, ji = (np.asarray(x) for x in jgeo.intersect_media(
        j_scene, _v3(o), _v3(d), tmin, tmax, jnp.asarray(u)))
    tt, ti = geometry.intersect_media(t_scene, to, td, 1e-3, geometry.INF,
                                      tu)
    hit = jt < 1e30
    np.testing.assert_array_equal(hit, tt.numpy() < 1e30)
    assert hit.mean() > 0.05, hit.mean()
    np.testing.assert_array_equal(ji[hit], ti.numpy()[hit])
    np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=1e-5)

    tm = np.zeros(n, np.float32)
    jt, jfam, jidx, _ = jgeo.intersect_all(j_scene, _v3(o), _v3(d), tm,
                                           tmin, tmax, jnp.asarray(u))
    t, fam, idx = geometry.intersect_all(t_scene, to, td, torch.zeros(n),
                                         1e-3, geometry.INF, tu)
    jt, jfam, jidx = (np.asarray(x) for x in (jt, jfam, jidx))
    # Off near-ties between the medium's t and the closest solid's.
    solid_t = torch.where(fam == geometry.FAM_MEDIUM, geometry.INF, t)
    ok = ~((np.abs(jt - t.numpy()) > 0) & (np.abs(
        jt - solid_t.numpy()) < 1e-5 * np.abs(jt)))
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(jfam[ok], fam.numpy()[ok])
    np.testing.assert_array_equal(jidx[ok], idx.numpy()[ok])
    assert (jfam == 2).any()
    jh = jgeo.make_hit(j_scene, _v3(o), _v3(d), tm, jt, jfam, jidx)
    th = geometry.make_hit(t_scene, to, td, torch.zeros(n), t, fam, idx)
    med = ok & (jfam == 2)
    np.testing.assert_array_equal(np.asarray(jh.mat_id)[med],
                                  th.mat_id.numpy()[med])
    assert np.asarray(jh.front_face)[med].all()
    assert th.front_face.numpy()[med].all()
    for j_c, t_c in zip(jh.normal, th.normal):
        np.testing.assert_array_equal(t_c.numpy()[med], np.asarray(j_c)[med])


def _smoke_state(n=1024, seed=3, name="cornell_smoke"):
    """rrt_tpu's scene, its packed camera-ray state and keys, and the
    port's (state, key bits, sphere pack, bg pack, SolidPacks)."""
    (j_scene, j_cam), _ = _both(name, 32, 32)
    ids = jnp.arange(n, dtype=jnp.int32)
    px, py = ids % 32, (ids // 32) % 32
    keys = jrng.sample_keys(jax.random.key(seed),
                            (py * 32 + px).astype(jnp.uint32), 0)
    o, d, tm = jgenerate_rays(j_cam, px, py, 32, 32, keys)
    st = jmk.pack_state(o, d, tm, V3.ones((n,)), V3.zeros((n,)),
                        jnp.zeros((n,), jnp.int32), jnp.ones((n,), bool),
                        jnp.zeros((n,)))
    t_scene = convert.scene_from_numpy(_leaves(j_scene))
    port = (torch.from_numpy(np.array(st)),
            torch.from_numpy(np.asarray(keys).view(np.int32).copy()),
            tmk.pack_spheres_full(t_scene), tmk.pack_bg(t_scene),
            tmk.pack_solids(t_scene))
    return j_scene, st, keys, port


@pytest.mark.parametrize("k_steps", [3])
def test_bounce_steps_matches_reference(interpret_pallas, k_steps):
    """The plain bounce_steps against rrt_tpu's Pallas kernel in
    interpret mode on cornell_smoke (its scalar quad loop and its media
    loop), tests/test_torch_queue.py's rule."""
    j_scene, st, keys, (state, kbits, sph, bg, solids) = _smoke_state()
    ref = np.asarray(jmk.bounce_steps(
        st, keys, jmk.pack_spheres_full(j_scene),
        jmk.pack_quads_full(j_scene), jmk.pack_media(j_scene),
        jmk.pack_bg(j_scene), k_steps=k_steps, moving=False, has_quads=True,
        n_media=2, max_depth=50, t_min=1e-3, fam_n=j_scene.fam_n))
    out = tmk.bounce_steps_reference(state, kbits, sph, bg, k_steps=k_steps,
                                     max_depth=50, t_min=1e-3, moving=False,
                                     solids=solids).numpy()
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    assert agree.mean() >= 0.98, agree.mean()
    np.testing.assert_array_equal(out[15][agree], ref[15][agree])
    np.testing.assert_array_equal(out[13][agree], ref[13][agree])
    close = np.all(np.abs(out[7:13] - ref[7:13]) < 1e-3, axis=0)[agree]
    assert close.mean() >= 0.97, close.mean()


@pytest.mark.parametrize("bounce", [0, 5])
def test_intersect_only_matches_reference(interpret_pallas, bounce):
    """The plain intersect_only against rrt_tpu's kernel (interpret mode)
    on cornell_smoke (quads and media, the family rrt_tpu's kernel
    covers): (fam, idx) on every ray off near-ties, t within 1e-5, the
    media's draws addressed by each ray's keys and bounce."""
    (j_scene, j_cam), _ = _both("cornell_smoke")
    t_scene = convert.scene_from_numpy(_leaves(j_scene))
    for kind in ("random", "camera"):
        o, d = _rays("cornell_smoke", j_scene, j_cam, kind, n=1024)
        n = o.shape[1]
        keys = np.random.default_rng(4).integers(0, 2 ** 32, (2, n),
                                                 dtype=np.uint64)
        keys = keys.astype(np.uint32)
        rays8 = jnp.asarray(np.concatenate(
            [o, d, np.zeros((1, n), np.float32),
             np.full((1, n), bounce, np.float32)]))
        jt, jfam, jidx = (np.asarray(x) for x in jmk.intersect_only(
            rays8, jnp.asarray(keys), jmk.pack_spheres_full(j_scene),
            jmk.pack_quads_full(j_scene), jmk.pack_media(j_scene),
            moving=False, has_quads=True, n_media=2, t_min=1e-3))
        t, fam, idx = tmk.intersect_only_reference(
            torch.from_numpy(o), torch.from_numpy(d),
            tmk.pack_spheres_full(t_scene), t_min=1e-3,
            solids=tmk.pack_solids(t_scene),
            keys=torch.from_numpy(keys.view(np.int32)),
            bounce=torch.full((n,), bounce, dtype=torch.int32))
        t, fam, idx = t.numpy(), fam.numpy(), idx.numpy()
        near = (jt != t) & (np.abs(jt - t) <= 1e-5 * np.abs(jt))
        off = ~near | (fam == jfam)
        assert off.mean() > 0.99
        np.testing.assert_array_equal(fam[off], jfam[off])
        hit = off & (jfam >= 0)
        np.testing.assert_array_equal(idx[hit], jidx[hit])
        np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5)
        assert (jfam == 2).any() and (jfam == 1).any()


@pytest.mark.parametrize("name", ["cornell_smoke"])
def test_drivers_agree_and_match_reference(interpret_pallas, name):
    """The tile, queue and batch drivers (the kernels' plain versions on
    the CPU) render the same image, and it matches rrt_tpu's tile render
    by tests/test_torch_slice.py's rule (media_scene's radiance is held
    to rrt_tpu's scan in tests/test_torch_media_grad.py)."""
    w = h = 12
    (j_scene, j_cam), (scene, cam) = _both(name, w, h)
    j_cfg = jrender.RenderConfig(width=w, height=h, spp=2, max_depth=8)
    j_img, j_n = jrender.render_image_tiles(j_scene, j_cam, j_cfg, 0)
    cfg = render.RenderConfig(width=w, height=h, spp=2, max_depth=8,
                              samples_per_pass=2, tile_pixels=100,
                              queue_size=200)
    tile, n_tile = render.render_image_tiles(scene, cam, cfg, 0, device="cpu")
    queue, n_queue = render.render_image_queue(scene, cam, cfg, 0,
                                               device="cpu")
    batch, n_batch = render.render_image(scene, cam, cfg, 0, device="cpu")
    assert int(n_tile) == int(n_queue) == int(n_batch)
    torch.testing.assert_close(queue, tile, atol=1e-5, rtol=0)
    torch.testing.assert_close(batch, tile, atol=1e-5, rtol=0)
    a, b = np.asarray(j_img), tile.numpy()
    close = np.abs(a - b).max(axis=2) < 1e-3
    assert close.mean() >= 0.985, close.mean()
    assert abs(int(n_tile) - float(j_n)) / float(j_n) < 1e-2


def test_medium_winners_are_coded():
    """A medium winner's code is MEDIUM_CODE + its slot (19,456, after the
    spheres' 3,072 codes and the quads' and boxes' CODE_SPAN each), and
    the plain train forward stores them on cornell_smoke."""
    fam = torch.tensor([geometry.FAM_MEDIUM, geometry.FAM_MEDIUM,
                        geometry.FAM_BOX, geometry.FAM_QUAD,
                        geometry.FAM_SPHERE, geometry.FAM_NONE])
    idx = torch.tensor([0, 7, 3, 5, 9, 0])
    code = tmk.encode_winner(fam, idx)
    assert tmk.MEDIUM_CODE == 19456
    assert code.tolist() == [19456, 19463, 11267, 3077, 9, -1]
    f2, i2 = tmk.decode_winner(code)
    assert f2.tolist() == fam.tolist()
    assert i2.tolist()[:5] == idx.tolist()[:5]
    scene, cam = tscenes.cornell_smoke_scene(8, 8)
    cfg = render.RenderConfig(width=8, height=8, spp=2, max_depth=4)
    sph, cam24, bg = render._packs(scene, cam, cfg, "cpu")
    _, _, _, winners = tmk.trace_paths_reference(
        sph, cam24, bg, seed_words=(0, 0), sample_lo=0, width=8, height=8,
        spp=2, max_depth=4, t_min=1e-3, moving=False,
        solids=tmk.pack_solids(scene), win_cap=16)
    assert (winners >= tmk.MEDIUM_CODE).any()


def test_cli_renders_cornell_smoke_on_the_tile_driver(tmp_path):
    """python -m rrt_tpu_torch.cli --scene cornell_smoke picks the tile
    driver (auto) and writes an image."""
    out = tmp_path / "smoke.ppm"
    assert cli.main(["--scene", "cornell_smoke", "-r", "8x8", "-s", "2",
                     "--max-depth", "4", "--device", "cpu", "--quiet",
                     "-o", str(out)]) == 0
    assert cli.resolve_driver("auto", tscenes.cornell_smoke_scene(8, 8)[0]) \
        == "tile"
    assert out.stat().st_size > 8 * 8 * 3
