"""The RTTNW final scene (rttnw_final) and the walks over the solid
families' trees against rrt_tpu, on the CPU.

The scene's layout and build(spatial_sort=True) equal rrt_tpu's bit for
bit. The plain walk over the quads' and boxes' trees
(accel.solid_closest_reference, the kernels' rule) gives the scan's (t,
family, slot) bit for bit, with fewer tests than the scan, on
rttnw_final's camera and bounced rays, on rays aimed at the exposed
shared edges of its ground boxes (-1000 + 100 i is exact in float32, so
neighbouring boxes tie there), on rays too short for the slabs' bound
(the loop), and on mixed_scene's and many_solids_scene's rotated boxes
and quads. The three drivers render rttnw_final alike and match
rrt_tpu's eager batch driver by the slice rule, and a few rays match
rrt_tpu's golden oracle. About 36 s alone on one CPU worker, most of
it rrt_tpu's jit and its golden oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrt_tpu
from rrt_tpu import golden
from rrt_tpu import render as jrender
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import Camera as JCamera
from rrt_tpu.scene import SceneBuilder as JBuilder
from rrt_tpu_torch import accel, geometry, render, rng
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.camera import Camera
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.scene import SceneBuilder
from rrt_tpu_torch.scenes import book2

W, H = 16, 8
T_MIN = 1e-3


def _assert_same_scene(j_scene, t_scene):
    """Every SceneArrays field equal bit for bit (tensors: dtype, shape
    and bytes; the static flags and counts: equal)."""
    for f in dataclasses.fields(j_scene):
        a, b = getattr(j_scene, f.name), getattr(t_scene, f.name)
        if isinstance(b, torch.Tensor):
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, (f.name, a, b)


def test_rttnw_final_layout_equals_rrt_tpu():
    """rttnw_final_scene(400, 267): every field of the Morton-ordered
    layout, and the camera, as rrt_tpu builds them."""
    j_scene, j_cam = jscenes.SCENES["rttnw_final"](400, 267)
    t_scene, t_cam = tscenes.SCENES["rttnw_final"](400, 267)
    _assert_same_scene(j_scene, t_scene)
    for f in dataclasses.fields(t_cam):
        np.testing.assert_array_equal(np.asarray(getattr(j_cam, f.name)),
                                      getattr(t_cam, f.name).numpy())
    assert (t_scene.n_spheres_active, t_scene.n_quads_active,
            t_scene.n_boxes_active, t_scene.n_media_active) == (1006, 1, 400,
                                                                2)


def _random_scene(builder, seed, n_spheres, n_quads, n_boxes):
    """The same calls on either package's builder: spheres (some moving),
    quads and boxes rotated about Y at random, the families padded with
    invalid slots."""
    rs = np.random.RandomState(seed)
    b = builder()
    mats = (b.lambertian((0.5, 0.4, 0.3)), b.metal((0.8, 0.8, 0.9), 0.2),
            b.dielectric(1.5))
    for i in range(n_spheres):
        c = rs.uniform(-50.0, 50.0, 3)
        if i % 5 == 0:
            b.moving_sphere(c, c + rs.uniform(-1.0, 1.0, 3), 0.0, 1.0,
                            float(rs.uniform(0.2, 2.0)), mats[i % 3])
        else:
            b.sphere(c, float(rs.uniform(0.2, 2.0)), mats[i % 3])
    for i in range(n_quads):
        b.quad(rs.uniform(-50.0, 50.0, 3), rs.uniform(-3.0, 3.0, 3),
               rs.uniform(-3.0, 3.0, 3), mats[i % 2],
               rotate_y_deg=float(rs.uniform(-90.0, 90.0)))
    for i in range(n_boxes):
        lo = rs.uniform(-50.0, 50.0, 3)
        b.box(lo, lo + rs.uniform(0.5, 4.0, 3), mats[i % 2],
              rotate_y_deg=float(rs.uniform(-90.0, 90.0)),
              translate=tuple(rs.uniform(-5.0, 5.0, 3)))
    return b


@pytest.mark.parametrize("seed,counts", [(0, (300, 30, 50)),
                                         (1, (40, 1, 0)),
                                         (2, (130, 0, 129))])
def test_spatial_sort_equals_rrt_tpu(seed, counts):
    """build(spatial_sort=True) on random builders (one sphere or quad,
    none, a family past one pad of 128): rrt_tpu's layout bit for bit,
    and another order than build()'s."""
    j_scene = _random_scene(JBuilder, seed, *counts).build(spatial_sort=True)
    t_scene = _random_scene(SceneBuilder, seed, *counts).build(
        spatial_sort=True)
    _assert_same_scene(j_scene, t_scene)
    plain = _random_scene(SceneBuilder, seed, *counts).build()
    assert not torch.equal(plain.sphere_c0, t_scene.sphere_c0)
    assert torch.equal(plain.sphere_valid, t_scene.sphere_valid)


def _camera_rays(scene, cam, w, h):
    ids = torch.arange(w * h)
    keys = rng.sample_keys(rng.key_words(0), ids, 0)
    o, d, tm = render.generate_rays(cam, ids % w, ids // w, w, h, keys)
    return o, d, tm, keys


def _bounced(scene, o, d, tm, keys, steps):
    """The live rays after `steps` bounce steps of bounce_steps' plain
    version (the scene's own families, no tree)."""
    n = o.shape[1]
    one, zero = torch.ones(n), torch.zeros(n)
    st = tmk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                        one, zero)
    st = tmk.bounce_steps(st, rng.u32_bits(keys), tmk.pack_spheres_full(scene),
                          tmk.pack_bg(scene), k_steps=steps, max_depth=50,
                          t_min=T_MIN, moving=scene.has_moving,
                          solids=tmk.pack_solids(scene),
                          tex=tmk.pack_textures(scene))
    live = st[tmk.ROW_ALIVE] > 0.5
    return st[0:3, live].contiguous(), st[3:6, live].contiguous()


def _edge_rays():
    """Rays from around rttnw_final's camera aimed at the edges where a
    ground box's side meets its lower neighbour's top (x = -1000 + 100 i),
    where the two boxes' t's tie exactly now and then."""
    scene, _ = tscenes.SCENES["rttnw_final"](W, H)
    c = scene.box_center[:400].numpy()
    top = c[:, 1] + scene.box_half[:400, 1].numpy()
    cell = {(round(float(x)), round(float(z))): k
            for k, (x, _, z) in enumerate(c)}
    rs = np.random.RandomState(1)
    pts = []
    for k, (x, _, z) in enumerate(c):
        nb = cell.get((round(float(x)) + 100, round(float(z))))
        if nb is not None:
            for _ in range(4):
                pts.append((x + 50.0, min(top[k], top[nb]),
                            z + rs.uniform(-50.0, 50.0)))
    tgt = torch.tensor(np.array(pts, np.float32)).T
    src = torch.tensor([[478.0], [278.0], [-600.0]]) + torch.from_numpy(
        rs.normal(0.0, 20.0, tgt.shape).astype(np.float32))
    return scene, src.contiguous(), (tgt - src).contiguous()


def _scan(scene, o, d):
    """The scan: geometry's quad and box tests over every active slot,
    merged (t, family, slot), slot 0 on a miss as the kernels give it."""
    tq, iq = geometry.intersect_quads(scene, o, d, T_MIN, geometry.INF)
    tb, ib = geometry.intersect_boxes(scene, o, d, T_MIN, geometry.INF)
    none = torch.full_like(tq, geometry.INF)
    t, fam, idx = geometry.merge_solid(none, torch.zeros_like(iq), tq, iq, tb,
                                       ib)
    return t, fam.to(torch.int32), torch.where(t < geometry.INF, idx,
                                               0).to(torch.int32)


def _rays(kind):
    """(scene, o, d) of each ray set."""
    if kind in ("camera", "bounced", "tiny"):
        scene, cam = tscenes.SCENES["rttnw_final"](400, 267)
        o, d, tm, keys = _camera_rays(scene, cam, 40, 27)
        if kind == "bounced":
            o, d = _bounced(scene, o, d, tm, keys, 2)
        if kind == "tiny":  # directions under TINY_DIR: the boxes' loop
            d = d * (accel.TINY_DIR / 4.0)
        return scene, o, d
    if kind == "edges":
        return _edge_rays()
    scene, cam = (book2.mixed_scene(48, 32) if kind == "mixed"
                  else book2.many_solids_scene(48, 32))
    o, d, tm, keys = _camera_rays(scene, cam, 48, 32)
    o2, d2 = _bounced(scene, o, d, tm, keys, 1)
    return scene, torch.cat([o, o2], 1), torch.cat([d, d2], 1)


def _trees(kind, quad24, box24, n_quads, n_boxes):
    """The SolidBvh the walk takes: the kernels' (pack_solid_bvh), or on
    mixed_scene, whose few quads and boxes the kernels loop over, each
    family's tree built all the same (accel.family_bvh)."""
    if kind != "mixed":
        return accel.pack_solid_bvh(quad24, box24, n_quads, n_boxes)
    return accel.SolidBvh(
        quad=accel.family_bvh(*accel.quad_slot_boxes(quad24, n_quads)),
        box=accel.family_bvh(*accel.box_slot_boxes(box24, n_boxes),
                             np.zeros(n_boxes, bool)))


@pytest.mark.parametrize("kind", ["camera", "bounced", "edges", "tiny",
                                  "mixed", "many"])
def test_solid_walk_is_the_scan(kind):
    """The plain walk over the families' trees (the kernels' rule) gives
    the scan's (t, family, slot) bit for bit; the walked families take
    fewer tests than the scan (the tiny rays test every box); the edge
    rays hold exact ties between boxes."""
    scene, o, d = _rays(kind)
    quad24, box24 = tmk.pack_quads_full(scene), tmk.pack_boxes_full(scene)
    tree = _trees(kind, quad24, box24, scene.n_quads_active,
                  scene.n_boxes_active)
    assert tree.quad.n_nodes or tree.box.n_nodes
    t, fam, idx, nodes, tests = accel.solid_closest_reference(
        o, d, quad24, box24, tree, t_min=T_MIN)
    t_s, fam_s, idx_s = _scan(scene, o, d)
    assert torch.equal(t, t_s) and torch.equal(fam, fam_s)
    assert torch.equal(idx, idx_s)
    assert (t < geometry.INF).float().mean() > 0.1
    scan_tests = scene.n_quads_active + scene.n_boxes_active
    walked = (nodes + tests).float().mean()
    if kind == "tiny":
        assert int(tests.min()) >= scene.n_boxes_active
    elif kind != "mixed":
        assert walked < 0.25 * scan_tests, (walked, scan_tests)
    if kind == "edges":
        roots = geometry.box_roots(scene.box_center, scene.box_half,
                                   scene.box_cos, scene.box_sin,
                                   scene.box_valid, o, d, T_MIN, geometry.INF)
        low = roots.min(dim=1).values[:, None]
        ties = ((roots == low) & (low < geometry.INF)).sum(dim=1) > 1
        assert int(ties.sum()) >= 5, int(ties.sum())


def test_walks_give_intersect_onlys_winners():
    """The solids' walk seeding the spheres' (the kernels' closest_hit
    without media) gives intersect_only's plain version's (t, family,
    slot) on rttnw_final's camera rays at their times."""
    scene, cam = tscenes.SCENES["rttnw_final"](400, 267)
    o, d, tm, _ = _camera_rays(scene, cam, 40, 27)
    sph24 = tmk.pack_spheres_full(scene)
    solids = dataclasses.replace(tmk.pack_solids(scene),
                                 n_media=0, med24=None)
    t_s, fam_s, idx_s, _, _ = accel.solid_closest_reference(
        o, d, solids.quad24, solids.box24, solids.tree, t_min=T_MIN)
    bvh = accel.pack_bvh(sph24, (0.0, 1.0))
    t, fam, idx, _, slots = accel.bvh_closest_reference(
        o, d, sph24, bvh, t_min=T_MIN, time=tm, seed=t_s)
    sphere = (fam == 0) & (t < t_s)
    fam = torch.where(sphere, geometry.FAM_SPHERE, fam_s)
    idx = torch.where(sphere, idx, idx_s)
    ref = tmk.intersect_only(o, d, sph24, t_min=T_MIN, time=tm,
                             solids=solids)
    assert torch.equal(t, ref[0]) and torch.equal(fam, ref[1])
    assert torch.equal(idx, ref[2])
    assert float(slots.float().mean()) < 0.1 * scene.n_spheres_active


def test_pack_solid_bvh_layout():
    """rttnw_final's trees: the one quad a loop, the 400 boxes a tree
    whose rows are every box once, each box inside its leaf's and the
    root's box; a family of SOLID_CAP boxes stays a loop, one more
    walks."""
    scene, _ = tscenes.SCENES["rttnw_final"](W, H)
    quad24, box24 = tmk.pack_quads_full(scene), tmk.pack_boxes_full(scene)
    tree = accel.pack_solid_bvh(quad24, box24, 1, 400)
    assert tree.quad.n_nodes == 0 and tree.box.n_nodes > 0
    assert sorted(tree.box.rows.tolist()) == list(range(400))
    lo, hi = accel.box_slot_boxes(box24, 400)
    nodes = tree.box.nodes.numpy()
    assert (nodes[0, 0:3] <= lo.min(0)).all()
    assert (nodes[0, 4:7] >= hi.max(0)).all()
    w1 = nodes[:, 7].view(np.int32)
    w0 = nodes[:, 3].view(np.int32)
    for i in np.nonzero(w1 > 0)[0]:
        slots = tree.box.rows[w0[i]:w0[i] + w1[i]].numpy()
        assert (nodes[i, 0:3] <= lo[slots]).all()
        assert (nodes[i, 4:7] >= hi[slots]).all()
    c = scene.box_center[:400]
    assert (lo <= c.numpy()).all() and (hi >= c.numpy()).all()
    assert tree.smem_bytes() == 32 * tree.box.n_nodes + 4 * 400
    cap = accel.SOLID_CAP
    assert accel.pack_solid_bvh(quad24, box24, 1, cap).box.n_nodes == 0
    assert accel.pack_solid_bvh(quad24, box24, 1, cap + 1).box.n_nodes > 0


def _slice_rule(img, ref, n, n_ref):
    close = (np.abs(img - ref).max(axis=-1) < 1e-3).mean()
    assert close >= 0.985, close
    assert abs(n - n_ref) / n_ref < 1e-2, (n, n_ref)


def test_drivers_match_rrt_tpu():
    """The tile, queue and batch drivers render rttnw_final alike (1e-5,
    the same traced count), and the batch driver matches rrt_tpu's eager
    batch driver by the slice rule (98.5% of pixels within 1e-3, traced
    totals within 1%) at 16x8, depth 8, 4 spp: rrt_tpu's eager sphere
    test cancels otherwise than the kernels' expanded quadratic 1,000
    units from the origin, so a path parts now and then."""
    scene, cam = tscenes.SCENES["rttnw_final"](W, H)
    cfg = render.RenderConfig(width=W, height=H, spp=4, max_depth=8,
                              samples_per_pass=4)
    tile, n_tile = render.render_image_tiles(scene, cam, cfg, 0, device="cpu")
    queue, n_queue = render.render_image_queue(scene, cam, cfg, 0,
                                               device="cpu")
    batch, n_batch = render.render_image(scene, cam, cfg, 0, device="cpu")
    for img, n in ((queue, n_queue), (tile, n_tile)):
        torch.testing.assert_close(img, batch, rtol=1e-5, atol=1e-5)
        assert int(n) == int(n_batch)
    j_scene, j_cam = jscenes.SCENES["rttnw_final"](W, H)
    j_cfg = rrt_tpu.RenderConfig(width=W, height=H, spp=4, max_depth=8,
                                 tile_pixels=4096, samples_per_pass=4)
    ref, n_ref = jrender.render_image(j_scene, j_cam, j_cfg, 0)
    _slice_rule(batch.numpy(), np.asarray(ref), int(n_batch), int(n_ref))
    assert (batch.amax(dim=2) > 0).float().mean() > 0.05


def test_batch_radiance_matches_golden():
    """tests/test_torch_golden.py's rule on 16 rays of the top rows (two
    see the light): every channel within 2e-3 + 1% of rrt_tpu's golden
    oracle at depth 50 (its boxes as six quads each), none parted."""
    n = 16
    ids = torch.arange(n) * 2
    px, py = ids % W, ids // W
    keys = rng.sample_keys(rng.key_words(7), py * W + px, 0)
    j_keys = jrng.sample_keys(jax.random.key(7),
                              jnp.asarray((py * W + px).numpy(), jnp.uint32),
                              0)
    scene, cam = tscenes.SCENES["rttnw_final"](W, H)
    o, d, tm = render.generate_rays(cam, px, py, W, H, keys)
    rad, _ = render.trace_batch(scene, o, d, tm, keys, 50, T_MIN)
    j_scene, _ = jscenes.SCENES["rttnw_final"](W, H)
    gs = golden.GoldenScene(j_scene)
    draws = golden.extract_draws(j_keys, j_scene.n_media, 50)
    o_np, d_np = o.T.numpy(), d.T.numpy()
    expected = np.stack([
        golden.trace_ray(gs, o_np[i], d_np[i], float(tm[i]), i, draws, 50)
        for i in range(n)])
    close = np.all(np.abs(rad.T.numpy() - expected)
                   <= 2e-3 + 1e-2 * np.abs(expected), axis=-1)
    assert close.all(), np.nonzero(~close)[0]
    assert (expected.max(axis=1) > 0).sum() >= 2


def _many_boxes(n, seed=0):
    """A box pack (24, n) of n random boxes, unrotated: centers within
    1,000 of the origin, half extents up to 10."""
    rs = np.random.RandomState(seed)
    box24 = np.zeros((24, n), np.float32)
    box24[0:3] = rs.uniform(-1000.0, 1000.0, (3, n))
    box24[3:6] = rs.uniform(1.0, 10.0, (3, n))
    box24[6] = 1.0
    return torch.from_numpy(box24)


def test_forward_smem_and_its_limit():
    """A forward kernel's shared memory (forward_smem_bytes, csrc's
    forward_smem): rttnw_final's staged spheres, box rows and boxes' tree
    fit in what a block may opt into; 7,000 boxes do not, and the check
    the wrappers make before a launch raises NotImplementedError naming
    the ROADMAP entry."""
    scene, cam = tscenes.SCENES["rttnw_final"](W, H)
    sph24 = tmk.pack_spheres_full(scene)
    bvh = accel.pack_bvh(sph24, render._shutter(cam))
    solids = tmk.pack_solids(scene)
    need = tmk.forward_smem_bytes(bvh, solids, True)
    up = lambda n: -(-n // 16) * 16  # noqa: E731
    assert need == (up(bvh.smem_bytes(True)) + up(16 * (3 + 2 * 400) + 4)
                    + solids.tree.smem_bytes())
    assert need < accel.BVH_SMEM
    tmk._check_forward_smem(bvh, solids, True, "render_tiles")
    box24 = _many_boxes(7000)
    big = dataclasses.replace(
        solids, box24=box24, n_boxes=7000,
        tree=accel.pack_solid_bvh(solids.quad24, box24, 1, 7000))
    assert big.tree.box.n_nodes > 0
    with pytest.raises(NotImplementedError, match="Queue C"):
        tmk._check_forward_smem(bvh, big, True, "render_tiles")


def test_many_solids_scene_equals_rrt_tpu():
    """many_solids_scene (the test scene of more than SOLID_CAP quads and
    boxes) builds rrt_tpu's layout with rrt_tpu's builder too."""
    j_scene, _ = book2.many_solids_scene(W, H, moving=True, marble=True,
                                         builder=JBuilder, camera=JCamera)
    t_scene, _ = book2.many_solids_scene(W, H, moving=True, marble=True)
    _assert_same_scene(j_scene, t_scene)
    assert min(t_scene.n_quads_active, t_scene.n_boxes_active) > \
        tmk.SOLID_CAP


def test_gradient_scopes():
    """The forward kernels and the train kernels take rttnw_final (train_fwd
    walks its boxes' tree, train_bwd loops over them); chain_bwd takes its
    400 boxes (its replay walks their tree on a card) but not its media
    (#9.4). On the CPU its gradient runs on the train kernels' plain
    versions (render_image_diff through trace_tiles_diff); on a CUDA
    device the train route passes its scope check and the chain's route
    raises before anything runs, naming the media; the train wrappers
    take its packs, and chain_adjoint takes them without the media
    (make_train_step's on the card: tests/test_torch_cuda.py)."""
    from rrt_tpu_torch.ops import megakernel_train as tmkt
    from rrt_tpu_torch.ops import megakernel_vjp as tmkv
    scene, cam = tscenes.SCENES["rttnw_final"](8, 4)
    assert tmk.scope_gap(scene) is None
    assert tmkt.train_scope_gap(scene) is None
    assert tmkv.backward_scope_gap(scene)[1] == "#9.4"
    cfg = render.RenderConfig(width=8, height=4, spp=1, max_depth=2,
                              samples_per_pass=1)
    assert render.diff_fallback_reason(scene, cfg) is None
    leaf = scene.sphere_c0.clone().requires_grad_(True)
    img, _ = render.render_image_diff(
        dataclasses.replace(scene, sphere_c0=leaf), cam, cfg, 0,
        device="cpu")
    img.sum().backward()
    assert torch.isfinite(leaf.grad).all()
    render._check_card_scope("render_image_diff", scene, "cuda")
    with pytest.raises(NotImplementedError, match="#9.4"):
        render.render_image(scene, cam, cfg, 0, differentiable=True,
                            device="cuda")
    sph24 = tmk.pack_spheres_full(scene)
    solids, tex = tmk.pack_solids(scene), tmk.pack_textures(scene)
    rad, _, lengths, _ = tmkt.render_tiles_train(
        sph24, tmk.pack_camera(cam, 8, 4), tmk.pack_bg(scene),
        seed_words=(0, 0), sample_lo=0, width=8, height=4, spp=1,
        max_depth=2, t_min=T_MIN, moving=True, solids=solids, tex=tex)
    assert torch.isfinite(rad).all() and int(lengths.sum()) >= 8 * 4
    state = torch.zeros((tmk.STATE_ROWS, 4))
    d_out = torch.ones_like(state)
    d_state, _, _, mism, d_solids, _ = tmkv.chain_adjoint(
        state, torch.zeros((2, 4), dtype=torch.int32), sph24,
        tmk.pack_bg(scene), d_out, torch.zeros(4), k_steps=1, max_depth=2,
        t_min=T_MIN, moving=True,
        solids=dataclasses.replace(solids, n_media=0, med24=None), tex=tex)
    assert torch.equal(d_state[:13], d_out[:13]) and int(mism) == 0
    assert d_solids.box24.shape == solids.box24.shape
