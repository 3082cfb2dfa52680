"""The Cornell box (quads, a diffuse_light and rotated boxes) through
rrt_tpu_torch, against rrt_tpu on the CPU.

cornell_box_scene (six quads, two boxes rotated about Y, no sphere) and
scenes.book2.mixed_scene (spheres in a BVH, quads, rotated boxes and a
quad light together, built with the same calls in both packages) at small
sizes: 16x16 or less, 1-2 spp, depth 8 or less. rrt_tpu's Pallas kernels
run in interpret mode, as tests/test_megakernel.py runs them. Rules:

  * scene arrays and camera element for element; the packs within 1e-6
    relative (the port's quad pack keeps q, u, v and derives rrt_tpu's
    plane-frame rows with geometry.quad_frames);
  * geometry: t within 1e-5 relative, family and slot equal on every ray
    whose two nearest candidates are not within 1e-5 of each other (an
    exact tie goes to the box in rrt_tpu's eager merge, to the quad in
    its kernel and everywhere in the port);
  * the kernels' plain versions against rrt_tpu's kernels: the rules of
    tests/test_torch_queue.py and tests/test_torch_slice.py (98.5% of
    pixels within 1e-3, traced within 1%); the three drivers against each
    other within 1e-5 (the same plain physics, the same keys);
  * the seeded BVH walk gives the seeded scan's (t, winner) bit for bit;
  * gradients of the checkpointed scan against rrt_tpu's scan,
    weighting out the lanes whose radiance parts by 1e-3
    (gradcheck.sample_agreement's rule), by tests/test_torch_chain.py's
    rule, on cornell and on the mixed scene, where the quads' and boxes'
    positions move the checker texture's hit points."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import rrt_tpu.ops.megakernel as jmk
from rrt_tpu import diff as jdiff
from rrt_tpu import geometry as jgeo
from rrt_tpu import render as jrender
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import Camera as JCamera
from rrt_tpu.camera import generate_rays as jgenerate_rays
from rrt_tpu.scene import SceneBuilder as JBuilder
from rrt_tpu.vec import V3
from rrt_tpu_torch import accel, cli, convert, diff, geometry, render, rng
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.ops import megakernel_vjp as tmkv
from rrt_tpu_torch.scene import SceneBuilder
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
    if name == "mixed":
        return (book2.mixed_scene(w, h, JBuilder, JCamera),
                book2.mixed_scene(w, h))
    return jscenes.SCENES[name](w, h), tscenes.SCENES[name](w, h)


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_scene_matches_reference(name):
    """The builder's arrays, flags and camera equal rrt_tpu's element for
    element, and rrt_tpu's scene carried across (convert) equals the
    port's builder's."""
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
    if name == "cornell":
        assert (t_scene.n_quads_active, t_scene.n_boxes_active,
                t_scene.n_spheres_active) == (6, 2, 0)
        assert t_scene.has_rot_boxes and t_scene.has_emissive
        assert tscenes.SCENES["cornell"] is tscenes.cornell_box_scene


def test_box_with_an_image_texture_builds_six_quads():
    """A box whose material carries an image builds rrt_tpu's six quads
    (RTTNW listing 6.2, rotated and translated), bit for bit, and their
    quad pack carries the image index in row 20."""
    from rrt_tpu_torch.scene import tensor_fields
    img = np.random.default_rng(2).uniform(0, 1, (4, 8, 3)).astype(
        np.float32)
    built = []
    for b in (SceneBuilder(), JBuilder()):
        b.sphere((0.0, 0.0, 0.0), 1.0, b.lambertian(b.image(img * 0.5)))
        b.box((0, 0, 0), (1, 2, 3), b.lambertian(b.image(img)),
              rotate_y_deg=-18.0, translate=(1.0, 0.0, 2.0))
        built.append(b.build())
    got, exp = built
    assert (got.n_quads_active, got.n_boxes_active) == (6, 0)
    for f in tensor_fields():
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(exp, f)), err_msg=f)
    quad24 = tmk.pack_quads_full(got)
    assert quad24[20, :6].tolist() == [1.0] * 6


def _rel_close(a, b, rtol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(b), 1e-30)
    np.testing.assert_array_less(np.abs(a - b), rtol * scale + 1e-30)


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_packs_match_reference(name):
    (j_scene, _), (t_scene, _) = _both(name)
    jq = np.asarray(jmk.pack_quads_full(j_scene))
    jb = np.asarray(jmk.pack_boxes_full(j_scene))
    solids = tmk.pack_solids(t_scene)
    tq, tb = solids.quad24.numpy(), solids.box24.numpy()
    nq, nb = t_scene.n_quads_active, t_scene.n_boxes_active
    assert (solids.n_quads, solids.n_boxes) == (nq, nb)
    assert tq.shape == (24, 128) and tb.shape == (24, 128)
    q = solids.quad24[:, :nq]
    fr = geometry.quad_frames(q[0:3], q[3:6], q[6:9])
    frames = torch.cat([fr.n, fr.g, fr.h, fr.d_plane[None], fr.q_g[None],
                        fr.q_h[None], fr.eps_n[None]]).numpy()
    _rel_close(frames, jq[0:13, :nq])
    np.testing.assert_array_equal(tq[9, :nq], jq[13, :nq])  # valid
    np.testing.assert_array_equal(tq[10:20, :nq], jq[14:24, :nq])  # mats
    np.testing.assert_array_equal(tb[:19], jb[:19, :tb.shape[1]])
    np.testing.assert_array_equal(
        tmk.pack_spheres_full(t_scene).numpy(),
        np.asarray(jmk.pack_spheres_full(j_scene))[:, :t_scene.n_spheres])


def _rays(j_scene, j_cam, kind, n=2048, seed=0):
    """(o, d) (3, n) float32: random rays inside the box, or camera
    rays."""
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
    o = g.uniform(5.0, 550.0, (3, n)).astype(np.float32)
    d = g.standard_normal((3, n)).astype(np.float32)
    return o, d


def _v3(x):
    return V3(*(jnp.asarray(c) for c in x))


def _untied(roots):
    """Rays whose two nearest candidates (over every family) are not
    within 1e-5 relative of each other."""
    r = np.sort(roots, axis=1)
    return ~((r[:, 0] < 1e30) & (r[:, 1] - r[:, 0] <= 1e-5 * r[:, 0]))


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_geometry_matches_reference(kind):
    """intersect_quads, intersect_boxes, intersect_all and make_hit
    against rrt_tpu.geometry's on cornell."""
    j_scene, j_cam = jscenes.cornell_box_scene(W, H)
    t_scene, _ = tscenes.cornell_box_scene(W, H)
    o, d = _rays(j_scene, j_cam, kind)
    n = o.shape[1]
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tmin, tmax = np.full(n, 1e-3, np.float32), np.full(n, 3e38, np.float32)
    jq = jgeo.intersect_quads(j_scene, _v3(o), _v3(d), tmin, tmax)
    jb = jgeo.intersect_boxes(j_scene, _v3(o), _v3(d), tmin, tmax)
    tq = geometry.intersect_quads(t_scene, to, td, 1e-3, geometry.INF)
    tb = geometry.intersect_boxes(t_scene, to, td, 1e-3, geometry.INF)
    fr = geometry.quad_frames(t_scene.quad_q.T, t_scene.quad_u.T,
                              t_scene.quad_v.T)
    roots = torch.cat([
        geometry.quad_roots(fr, t_scene.quad_valid, to, td, 1e-3,
                            geometry.INF),
        geometry.box_roots(t_scene.box_center, t_scene.box_half,
                           t_scene.box_cos, t_scene.box_sin,
                           t_scene.box_valid, to, td, 1e-3, geometry.INF),
    ], dim=1).numpy()
    ok = _untied(roots)
    assert ok.mean() > 0.99
    for (jt, ji), (tt, ti) in ((jq, tq), (jb, tb)):
        jt, ji = np.asarray(jt), np.asarray(ji)
        hit = jt < 1e30
        np.testing.assert_array_equal(hit, tt.numpy() < 1e30)
        np.testing.assert_array_equal(ji[hit & ok], ti.numpy()[hit & ok])
        np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=1e-5)
    tm = np.zeros(n, np.float32)
    jt, jfam, jidx, _ = jgeo.intersect_all(j_scene, _v3(o), _v3(d), tm,
                                           tmin, tmax, None)
    t, fam, idx = geometry.intersect_all(t_scene, to, td, None, 1e-3,
                                         geometry.INF)
    jfam, jidx = np.asarray(jfam), np.asarray(jidx)
    np.testing.assert_array_equal(jfam[ok], fam.numpy()[ok])
    np.testing.assert_array_equal(jidx[ok], idx.numpy()[ok])
    assert set(np.unique(jfam)) >= {1, 3} if kind == "random" else True
    jh = jgeo.make_hit(j_scene, _v3(o), _v3(d), tm, jt, jfam, jidx)
    th = geometry.make_hit(t_scene, to, td, torch.from_numpy(tm), t, fam,
                           idx)
    hit = ok & (jfam >= 0)
    np.testing.assert_array_equal(np.asarray(jh.mat_id)[hit],
                                  th.mat_id.numpy()[hit])
    np.testing.assert_array_equal(np.asarray(jh.front_face)[hit],
                                  th.front_face.numpy()[hit])
    for j_c, t_c in zip(jh.normal, th.normal):
        np.testing.assert_allclose(t_c.numpy()[hit], np.asarray(j_c)[hit],
                                   atol=1e-6)
    for j_c, t_c in zip(jh.p, th.p):
        np.testing.assert_allclose(t_c.numpy()[hit], np.asarray(j_c)[hit],
                                   rtol=1e-5, atol=1e-3)


def test_inside_start_hits_the_far_face():
    """A ray starting inside a box leaves through its far face."""
    t_scene, _ = tscenes.cornell_box_scene(W, H)
    c = t_scene.box_center[0]
    o = c[:, None].repeat(1, 2).contiguous()
    d = torch.tensor([[0.0, 0.0], [1.0, -1.0], [0.0, 0.0]])
    t, idx = geometry.intersect_boxes(t_scene, o, d, 1e-3, geometry.INF)
    torch.testing.assert_close(t, t_scene.box_half[0, 1].repeat(2))
    assert idx.tolist() == [0, 0]


def _cornell_state(n=1024, seed=3, name="cornell"):
    """rrt_tpu's scene, its packed camera-ray state and keys, and the
    port's (state, key bits, sphere pack, bg pack, SolidPacks)."""
    if name == "mixed":
        j_scene, j_cam = book2.mixed_scene(32, 32, JBuilder, JCamera)
    else:
        j_scene, j_cam = jscenes.cornell_box_scene(32, 32)
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


@pytest.mark.parametrize("k_steps", [1, 3])
def test_bounce_steps_matches_reference(interpret_pallas, k_steps):
    """The plain bounce_steps against rrt_tpu's Pallas kernel in
    interpret mode on cornell (its scalar quad and box loops and the
    zero-sphere skip, fam_n), tests/test_torch_queue.py's rule."""
    j_scene, st, keys, (state, kbits, sph, bg, solids) = _cornell_state()
    ref = np.asarray(jmk.bounce_steps(
        st, keys, jmk.pack_spheres_full(j_scene),
        jmk.pack_quads_full(j_scene), jmk.pack_media(j_scene),
        jmk.pack_bg(j_scene), boxes24=jmk.pack_boxes_full(j_scene),
        k_steps=k_steps, moving=False, has_quads=True, has_boxes=True,
        has_rot_boxes=True, n_media=0, max_depth=50, t_min=1e-3,
        fam_n=j_scene.fam_n))
    out = tmk.bounce_steps_reference(state, kbits, sph, bg, k_steps=k_steps,
                                     max_depth=50, t_min=1e-3, moving=False,
                                     solids=solids).numpy()
    assert float(ref[15].sum()) >= 1024
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    assert agree.mean() >= 0.98, agree.mean()
    np.testing.assert_array_equal(out[15][agree], ref[15][agree])
    np.testing.assert_array_equal(out[13][agree], ref[13][agree])
    close = np.all(np.abs(out[7:13] - ref[7:13]) < 1e-3, axis=0)[agree]
    assert close.mean() >= 0.97, close.mean()
    assert (ref[10:13] > 0).any()  # some lanes reached the light


def test_intersect_only_matches_reference(interpret_pallas):
    """The plain intersect_only against rrt_tpu's kernel (interpret mode)
    on a scene of quads (cornell's walls and light), and against
    rrt_tpu.geometry.intersect_boxes on cornell's boxes (rrt_tpu's
    kernel has no box family)."""
    b = JBuilder()
    b.solid_background((0.0, 0.0, 0.0))
    jscenes.book2._cornell_walls(b, (15.0, 15.0, 15.0), (213.0, 554.0, 227.0),
                                 (130.0, 0.0, 0.0), (0.0, 0.0, 105.0))
    walls = b.build()
    j_scene, j_cam = jscenes.cornell_box_scene(W, H)
    for kind in ("random", "camera"):
        o, d = _rays(j_scene, j_cam, kind, n=1024)
        n = o.shape[1]
        rays8 = jnp.asarray(np.concatenate([o, d, np.zeros((2, n),
                                                           np.float32)]))
        keys = jnp.zeros((2, n), jnp.uint32)
        jt, jfam, jidx = (np.asarray(x) for x in jmk.intersect_only(
            rays8, keys, jmk.pack_spheres_full(walls),
            jmk.pack_quads_full(walls), jmk.pack_media(walls), moving=False,
            has_quads=True, n_media=0, t_min=1e-3))
        t_walls = convert.scene_from_numpy(_leaves(walls))
        to, td = torch.from_numpy(o), torch.from_numpy(d)
        t, fam, idx = tmk.intersect_only_reference(
            to, td, tmk.pack_spheres_full(t_walls), t_min=1e-3,
            solids=tmk.pack_solids(t_walls))
        np.testing.assert_array_equal(fam.numpy(), jfam)
        hit = jfam >= 0
        np.testing.assert_array_equal(idx.numpy()[hit], jidx[hit])
        np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=1e-5)
        # Boxes: cornell's whole scene, the box hits against geometry's.
        t_scene = convert.scene_from_numpy(_leaves(j_scene))
        t, fam, idx = tmk.intersect_only_reference(
            to, td, tmk.pack_spheres_full(t_scene), t_min=1e-3,
            solids=tmk.pack_solids(t_scene))
        tmin = np.full(n, 1e-3, np.float32)
        bt, bi = (np.asarray(x) for x in jgeo.intersect_boxes(
            j_scene, _v3(o), _v3(d), tmin, np.full(n, 3e38, np.float32)))
        box = fam.numpy() == 3
        assert box.any()
        np.testing.assert_array_equal(idx.numpy()[box], bi[box])
        np.testing.assert_allclose(t.numpy()[box], bt[box], rtol=1e-5)
        assert set(fam.numpy().tolist()) <= {-1, 1, 3}


def test_drivers_agree_and_match_reference(interpret_pallas):
    """The tile, queue and batch drivers on cornell (the kernels' plain
    versions on the CPU) render the same image, and it matches
    rrt_tpu's tile render by tests/test_torch_slice.py's rule."""
    j_scene, j_cam = jscenes.cornell_box_scene(W, H)
    j_cfg = jrender.RenderConfig(width=W, height=H, spp=2, max_depth=8)
    j_img, j_n = jrender.render_image_tiles(j_scene, j_cam, j_cfg, 0)
    scene, cam = tscenes.cornell_box_scene(W, H)
    cfg = render.RenderConfig(width=W, height=H, spp=2, max_depth=8,
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
    assert float(tile.max()) >= 7.5  # a camera ray on the light (15)


def _seeded_scan(o, d, sph24, seed):
    """The seeded scan: the first sphere slot with a root strictly below
    the seed, else the seed (win -1); unseeded (seed INF), the first
    minimum (0 on a miss)."""
    spheres = tmk._scene_from_packs(sph24, None, False)
    t_s, i_s = geometry.intersect_spheres(spheres, o, d, None, 1e-3,
                                          geometry.INF)
    won = (t_s < seed) | (seed == geometry.INF)
    return torch.where(won, t_s, seed), torch.where(won, i_s, -1)


def test_seeded_walk_equals_seeded_scan():
    """The BVH walk seeded by the quads' and boxes' t gives the seeded
    scan's (t, winner) bit for bit on the mixed scene: camera rays,
    rays after 1-3 bounces, and random rays with random seeds."""
    scene, cam = book2.mixed_scene(32, 32)
    packed = render.pack_scene(scene, "cpu", render._shutter(cam))
    sph, bvh, solids = packed["sph24"], packed["bvh"], packed["solids"]
    assert bvh.n_nodes > 1 and bvh.n_always == 1
    ids = torch.arange(1024)
    keys = rng.sample_keys(rng.key_words(1), ids, 0)
    o, d, tm = render.generate_rays(cam, ids % 32, ids // 32, 32, 32, keys)
    st = tmk.pack_state(o, d, tm, torch.ones_like(o), torch.zeros_like(o),
                        torch.zeros_like(tm), torch.ones_like(tm),
                        torch.zeros_like(tm))
    g = torch.Generator().manual_seed(5)
    ro = torch.randn((3, 1024), generator=g) * 3.0 + torch.tensor(
        [[0.0], [1.0], [0.0]])
    rd = torch.randn((3, 1024), generator=g)
    cases = [(ro, rd, torch.where(torch.rand(1024, generator=g) < 0.5,
                                  torch.rand(1024, generator=g) * 6.0,
                                  torch.full((1024,), geometry.INF)))]
    kb = rng.u32_bits(keys)
    for _ in range(3):
        o, d = st[0:3].clone(), st[3:6].clone()
        t_solid, _, _ = tmk.intersect_only_reference(
            o, d, _no_spheres(sph), t_min=1e-3, solids=solids)
        cases.append((o, d, t_solid))
        tmk.bounce_steps_reference(st, kb, sph, tmk.pack_bg(scene),
                                   k_steps=1, max_depth=50, t_min=1e-3,
                                   moving=False, solids=solids)
    seeded = 0
    for o, d, seed in cases:
        t, fam, win, _, _ = accel.bvh_closest_reference(
            o, d, sph, bvh, t_min=1e-3, seed=seed)
        t_ref, w_ref = _seeded_scan(o, d, sph, seed)
        assert torch.equal(t, t_ref) and torch.equal(win.long(), w_ref)
        flat = accel.bvh_closest_reference(o, d, sph, accel.pack_scan(sph),
                                           t_min=1e-3, seed=seed)
        assert torch.equal(flat[0], t) and torch.equal(flat[2], win)
        seeded += int(((win == -1) & (seed < geometry.INF)).sum())
        assert bool((fam == torch.where((win >= 0) & (t < geometry.INF), 0,
                                        -1)).all())
    assert seeded > 100  # the solids' t stands on many rays


def _no_spheres(sph24):
    """A sphere pack of sph24's width whose slots are all invalid."""
    empty = torch.zeros_like(sph24)
    empty[3] = -1.0
    empty[18] = 1.0
    return empty


def test_scopes():
    """The forward kernels, the train kernels and chain_bwd take cornell
    (#9.7 is ported): its gradients need no fallback. rttnw_final, whose
    400 ground boxes pass SOLID_CAP, is in SCENES and the forward and
    train kernels' scopes (#9.5's rest), and outside chain_bwd's for its
    constant media alone, naming #9.4 (chain_bwd walks its boxes' tree):
    on the CPU render_image_diff takes the train kernels' plain
    versions; cornell_smoke (#9.4) is in
    SCENES, and in every scope but chain_bwd's; simple_light and earth
    (#9.5's first part) are in SCENES and in every scope."""
    scene, cam = tscenes.cornell_box_scene(8, 8)
    assert tmk.scope_gap(scene) is None
    assert tmkv.backward_scope_gap(scene) is None
    assert tmkv.supports_backward(scene)
    cfg = render.RenderConfig(width=8, height=8, spp=1, max_depth=2)
    assert render.diff_fallback_reason(scene, cfg) is None
    rad, n = render.trace_tiles_diff(scene, cam, cfg, 0, device="cpu")
    ref, n_ref = render.trace_tiles(scene, cam, cfg, 0, device="cpu")
    assert torch.equal(rad, ref) and int(n) == int(n_ref)
    smoke, _ = tscenes.SCENES["cornell_smoke"](8, 8)
    assert tmk.scope_gap(smoke) is None
    assert render.diff_fallback_reason(smoke, cfg) is None
    assert tmkv.backward_scope_gap(smoke)[1] == "#9.4"
    for name in ("simple_light", "earth"):
        t_scene, _ = tscenes.SCENES[name](8, 8)
        assert tmk.scope_gap(t_scene) is None, name
        assert tmkv.backward_scope_gap(t_scene) is None, name
        assert render.diff_fallback_reason(t_scene, cfg) is None, name
    items = {"rttnw_final": "#9.4"}
    for name, item in items.items():
        j_scene, j_cam = jscenes.SCENES[name](8, 8)
        t_scene = convert.scene_from_numpy(_leaves(j_scene))
        t_cam = convert.camera_from_numpy(_leaves(j_cam))
        assert tmk.scope_gap(t_scene) is None, name
        assert tmkt.train_scope_gap(t_scene) is None, name
        assert tmkv.backward_scope_gap(t_scene)[1] == item, name
        assert "constant media" in tmkv.backward_scope_gap(t_scene)[0]
        assert name in tscenes.SCENES
        img, _ = render.render_image_tiles(t_scene, t_cam, cfg, 0,
                                           device="cpu")
        assert render.diff_fallback_reason(t_scene, cfg) is None
        diff_img, _ = render.render_image_diff(
            t_scene, t_cam, dataclasses.replace(cfg, samples_per_pass=1), 0,
            device="cpu")
        assert torch.isfinite(img).all() and torch.isfinite(diff_img).all()
        with pytest.raises(NotImplementedError, match=item):
            render.render_image(t_scene, t_cam, dataclasses.replace(
                cfg, samples_per_pass=1), 0, differentiable=True,
                device="cuda")


def test_cornell_gradient_raises_for_a_cuda_device():
    """On a CUDA device a differentiable render runs the train kernels or
    the bounce chain, never the checkpointed scan: cornell and
    cornell_smoke pass the train kernels' card scope check (their
    backwards are ported, #9.7 and #9.4); a scene with constant media
    raises naming #9.4 before it touches the device on the bounce chain's
    route (render_image(differentiable=True)), and one with more than
    MAX_TRAIN_MEDIA media on the train kernels' (tests/test_torch_cuda.py
    runs the gradients on the card)."""
    cornell, _ = tscenes.cornell_box_scene(8, 8)
    render._check_card_scope("cornell", cornell, "cuda")
    j_scene, j_cam = jscenes.SCENES["cornell_smoke"](8, 8)
    scene = convert.scene_from_numpy(_leaves(j_scene))
    cam = convert.camera_from_numpy(_leaves(j_cam))
    render._check_card_scope("cornell_smoke", scene, "cuda")
    cfg = render.RenderConfig(width=8, height=8, spp=1, max_depth=2)
    fog = SceneBuilder()
    for i in range(tmkt.MAX_TRAIN_MEDIA + 1):
        fog.medium_sphere((float(i), 0.0, 0.0), 0.4, 0.5, (0.5, 0.5, 0.5))
    with pytest.raises(NotImplementedError, match="#9.4"):
        render.render_image_diff(fog.build(), cam, cfg, 0, device="cuda")
    with pytest.raises(NotImplementedError, match="#9.4"):
        render.render_image(scene, cam, cfg, 0, differentiable=True,
                            device="cuda")
    spheres, _ = tscenes.chap12_scene(8, 8)
    render._check_card_scope("chap12", spheres, "cuda")


def test_solid_cap_raises():
    """Past SOLID_CAP active quads or boxes no wrapper raises any more:
    chain_adjoint takes them (its replay walks a family's tree on the
    card, as bounce_steps does; #9.5's chain part is ported), as the
    train wrappers (train_fwd walks, train_bwd loops) and the forward
    kernels' plain versions do, and no scope names #9.5."""
    scene, cam = tscenes.cornell_box_scene(8, 8)
    solids = dataclasses.replace(tmk.pack_solids(scene),
                                 n_boxes=tmk.SOLID_CAP + 1)
    sph24 = tmk.pack_spheres_full(scene)
    rad, _, lengths, winners = tmkt.render_tiles_train(
        sph24, tmk.pack_camera(cam, 8, 8), tmk.pack_bg(scene),
        seed_words=(0, 0), sample_lo=0, width=8, height=8, spp=1,
        max_depth=2, t_min=1e-3, moving=False, solids=solids)
    assert torch.isfinite(rad).all()
    state = torch.zeros((tmk.STATE_ROWS, 4))
    d_state, _, _, mism, d_solids, _ = tmkv.chain_adjoint(
        state, torch.zeros((2, 4), dtype=torch.int32), sph24,
        tmk.pack_bg(scene), state, torch.zeros(4), k_steps=1, max_depth=2,
        t_min=1e-3, moving=False, solids=solids)
    assert not d_state.any() and int(mism) == 0
    assert d_solids.n_boxes == tmk.SOLID_CAP + 1
    o = torch.zeros((3, 4))
    t, _, _ = tmk.intersect_only(o, o + 1.0, sph24, t_min=1e-3,
                                 solids=solids)
    assert t.shape == (4,)
    big = dataclasses.replace(scene, n_boxes_active=tmk.SOLID_CAP + 1)
    assert tmk.scope_gap(big) is None
    assert tmkt.train_scope_gap(big) is None
    assert tmkv.backward_scope_gap(big) is None


DEPTH, N = 4, 256
MIX = (1.0, 0.7, 0.3)


def _lane_ids():
    ids = np.arange(N)
    return ids % W, (ids // W) % H


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_scan_gradients_match_reference(name):
    """render's checkpointed scan (the route of cornell's gradients on
    the CPU) against rrt_tpu's trace_batch(differentiable=True): the loss
    sum(sin(0.1 i) MIX . radiance) and the gradients of quad_q, quad_u,
    quad_v, box_center, tex_color1 (the albedos and the light's
    emission) and bg_bottom, with the lanes whose radiance parts by 1e-3
    weighted out. On cornell, whose textures are solid, the quads' and
    boxes' positions get no gradient; on the mixed scene rays leave the
    quads and boxes for the spheres, whose normals, and so the sky the
    rays reach, move with those positions: there rrt_tpu's gradients of
    quad_q and box_center are not 0, and the port's must match them."""
    j_scene, j_cam = _both(name)[0]
    px, py = (jnp.asarray(a, jnp.int32) for a in _lane_ids())
    j_keys = jrng.sample_keys(jax.random.key(0),
                              (py * W + px).astype(jnp.uint32), 0)

    def j_rad(params):
        s = jdiff.combine(j_scene, params)
        o, d, tm = jgenerate_rays(j_cam, px, py, W, H, j_keys)
        r, _ = jrender.trace_batch(s, o, d, tm, j_keys, DEPTH, 1e-3,
                                   differentiable=True)
        return jnp.stack([r.x, r.y, r.z])

    ref, vjp = jax.vjp(jax.jit(j_rad), jdiff.partition(j_scene))
    ref = np.asarray(ref)

    scene = convert.scene_from_numpy(_leaves(j_scene))
    cam = convert.camera_from_numpy(_leaves(j_cam))
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    tpx, tpy = (torch.from_numpy(a) for a in _lane_ids())
    keys = rng.sample_keys(rng.key_words(0), tpy * W + tpx, 0)
    o, d, tm = render.generate_rays(cam, tpx, tpy, W, H, keys)
    rad, _ = render.trace_batch(diff.combine(scene, params), o, d, tm, keys,
                                DEPTH, 1e-3, differentiable=True)
    agree = (np.abs(rad.detach().numpy() - ref) < 1e-3).all(axis=0)
    assert agree.mean() >= 0.985, agree.mean()
    w = np.sin(np.arange(N) * 0.1).astype(np.float32) * agree
    cot = (np.asarray(MIX, np.float32)[:, None] * w).astype(np.float32)
    loss = float((cot * rad.detach().numpy()).sum())
    assert loss == pytest.approx(float((cot * ref).sum()), rel=1e-4)
    (gj,) = vjp(jnp.asarray(cot))
    gs = torch.autograd.grad(rad, list(params.values()), torch.from_numpy(cot),
                             allow_unused=True)
    got = {k: np.zeros(v.shape, np.float32) if g is None else g.numpy()
           for (k, v), g in zip(params.items(), gs)}
    lights = np.flatnonzero(
        scene.mat_type[scene.quad_mat[:scene.n_quads_active]].numpy() == 3)
    assert len(lights) == 1
    light = int(scene.mat_tex[scene.quad_mat[int(lights[0])]])
    assert np.abs(np.asarray(gj["tex_color1"])[light]).max() > 0
    if name == "mixed":
        for k in ("quad_q", "box_center"):
            assert np.abs(np.asarray(gj[k])).max() > 0, k
    for k in ("quad_q", "quad_u", "quad_v", "box_center", "tex_color1",
              "bg_bottom"):
        b = np.asarray(gj[k])
        a = got[k]
        assert np.isfinite(a).all(), k
        tol = 2e-3 * max(np.abs(b).max(), 1e-4)
        assert (np.abs(a - b) <= tol).all(), (k, a, b)


def test_train_step_takes_the_scan_route(monkeypatch, caplog):
    """make_train_step and render_image_diff on cornell take the train
    kernels (their plain versions on the CPU) with no fallback log line,
    and render_image(differentiable=True) takes the bounce chain
    (chain_adjoint); the checkpointed scan is not run."""
    calls = []
    for mod, name in ((tmkt, "render_tiles_train_reference"),
                      (tmkt, "tiles_adjoint_reference"),
                      (tmkv, "chain_adjoint_reference")):
        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(render, "checkpoint", lambda *a, **k: calls.append(
        "checkpoint"))
    scene, cam = tscenes.cornell_box_scene(8, 8)
    cfg = render.RenderConfig(width=8, height=8, spp=2, max_depth=3,
                              samples_per_pass=2)
    render._warned_fallbacks.clear()
    with caplog.at_level(logging.WARNING, logger="rrt_tpu_torch.render"):
        target, _ = render.render_image_tiles(scene, cam, cfg, 1,
                                              device="cpu")
        img, n = render.render_image_diff(scene, cam, cfg, 0, device="cpu")
        torch.testing.assert_close(img, render.render_image_tiles(
            scene, cam, cfg, 0, device="cpu")[0], atol=0, rtol=0)
        start = diff.combine(scene, {"tex_color1": scene.tex_color1 * 0.9})
        step = diff.make_train_step(cfg, lr=1.0, device="cpu")
        new, _, loss = step(start, cam, target, 0)
        assert calls == ["render_tiles_train_reference"] * 2 + [
            "tiles_adjoint_reference"]
        fwd, n_fwd = render.render_image(scene, cam, cfg, 0, device="cpu")
        albedo = scene.tex_color1.clone().requires_grad_()
        dimg, dn = render.render_image(
            diff.combine(scene, {"tex_color1": albedo}), cam, cfg, 0,
            differentiable=True, device="cpu")
        torch.testing.assert_close(dimg, fwd, atol=1e-5, rtol=0)
        assert int(dn) == int(n_fwd)
        dimg.sum().backward()
        assert albedo.grad.abs().max() > 0
    assert "chain_adjoint_reference" in calls and "checkpoint" not in calls
    assert bool(torch.isfinite(loss))
    assert not torch.equal(new.tex_color1, start.tex_color1)
    assert not [r for r in caplog.records
                if "batch driver's differentiable path" in r.getMessage()]


def test_cli_renders_cornell_on_the_tile_driver(tmp_path):
    """--scene cornell through the CLI: auto picks the tile driver, and
    the image is render_image_tiles'."""
    scene, _ = tscenes.cornell_box_scene(W, H)
    assert cli.resolve_driver("auto", scene) == "tile"
    out = tmp_path / "cornell.ppm"
    argv = ["--scene", "cornell", "-r", f"{W}x{H}", "-s", "2", "-e", "0",
            "--max-depth", "6", "--device", "cpu", "-o", str(out),
            "--quiet"]
    res = cli.render(cli.build_parser().parse_args(argv))
    assert res.driver == "tile" and out.stat().st_size > 0
    scene, cam = tscenes.cornell_box_scene(W, H)
    cfg = render.RenderConfig(width=W, height=H, spp=2, max_depth=6)
    img, n = render.render_image_tiles(scene, cam, cfg, 0, device="cpu")
    torch.testing.assert_close(res.image, img, atol=1e-6, rtol=0)
    assert res.n_traced == int(n)
