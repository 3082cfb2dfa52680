"""The port's closest-sphere BVH (rrt_tpu_torch/accel.py), on the CPU.

build_sphere_bvh equals rrt_tpu.accel.build_sphere_bvh node for node,
and build_bvh equals rrt_tpu.accel.build_bvh on random boxes whose
centroids coincide in part or all.
The kernels' walk, in its plain form (bvh_closest_reference over
pack_bvh's layout), gives intersect_only_reference's (t, fam, idx) bit
for bit: on camera rays, on the same rays after 1-4 bounce steps, on
rays leaving the ground sphere's surface and on rays grazing small
spheres, static and moving; and on the lanes the queue driver and the
differentiable batch driver hand bounce_steps and chain_bwd, with the
pack each builds once a call and passes to every launch. Every root a
slot gives under the plain arithmetic lies inside the slot's padded box
(the walk's premise), and a tree too deep or too large for the kernels
raises."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from rrt_tpu import accel as jaccel
from rrt_tpu import scenes as jscenes
from rrt_tpu_torch import accel, geometry, render, rng, scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_vjp as tmkv

W, H = 48, 27
FIELDS = ("node_min", "node_max", "left", "right", "axis", "prim_start",
          "prim_count", "prim_order")


@pytest.mark.parametrize("name", ["chap12", "chap11", "book2chap2"])
def test_build_matches_rrt_tpu(name):
    ours = accel.build_sphere_bvh(tscenes.SCENES[name](W, H)[0])
    ref = jaccel.build_sphere_bvh(jscenes.SCENES[name](W, H)[0])
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(ours, field),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


def _random_boxes(kind, n, seed):
    """n primitive boxes made from a seed: "spread" centers anywhere,
    "grid" centers on a 3 x 3 x 3 lattice (many coincide, so splits go
    degenerate deep in the tree), "coincident" one center for all (every
    split is degenerate)."""
    gen = np.random.default_rng(seed)
    if kind == "spread":
        c = gen.uniform(-50.0, 50.0, (n, 3))
    elif kind == "grid":
        c = gen.integers(-1, 2, (n, 3)) * 4.0
    else:
        c = np.full((n, 3), 1.5)
    r = gen.uniform(0.1, 2.0, (n, 1))
    ids = gen.permutation(4 * n)[:n].astype(np.int32)
    return ((c - r).astype(np.float32), (c + r).astype(np.float32), ids)


@pytest.mark.parametrize("kind,n,seed", [
    ("spread", 1, 0), ("spread", 5, 1), ("spread", 300, 2),
    ("grid", 40, 3), ("grid", 257, 4), ("coincident", 9, 5),
    ("coincident", 70, 6)])
def test_build_bvh_matches_rrt_tpu_on_random_boxes(kind, n, seed):
    """The level-at-a-time builder against rrt_tpu's recursion node for
    node, on random boxes, with the per-split EqualCount fallback taken
    where centroids coincide."""
    lo, hi, ids = _random_boxes(kind, n, seed)
    ours = accel.build_bvh(lo, hi, ids)
    ref = jaccel.build_bvh(lo, hi, ids)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(ours, field),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


def _camera_state(name, seed=0):
    """The scene, its packs, camera-ray lane state (16, W*H), keys."""
    scene, cam = tscenes.SCENES[name](W, H)
    n = W * H
    ids = torch.arange(n)
    keys = rng.sample_keys(rng.key_words(seed), ids, 0)
    o, d, tm = render.generate_rays(cam, ids % W, ids // W, W, H, keys)
    one, zero = torch.ones((n,)), torch.zeros((n,))
    st = tmk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                        one, zero)
    packed = render.pack_scene(scene, "cpu", render._shutter(cam))
    return scene, packed, st, rng.u32_bits(keys)


def _same(o, d, time, packed):
    kw = dict(t_min=1e-3, time=time)
    ref = tmk.intersect_only_reference(o.contiguous(), d.contiguous(),
                                       packed["sph24"], **kw)
    t, fam, idx, nodes, slots = accel.bvh_closest_reference(
        o.contiguous(), d.contiguous(), packed["sph24"], packed["bvh"], **kw)
    for a, b in zip((t, fam, idx), ref):
        assert torch.equal(a, b)
    return ref, nodes, slots


@pytest.mark.parametrize("name", ["chap12", "book2chap2"])
def test_walk_equals_scan_on_camera_and_bounced_rays(name):
    scene, packed, st, keys = _camera_state(name)
    bvh = packed["bvh"]
    assert bvh.n_always == 1 and int(bvh.rows[0]) == 0  # the ground
    assert bvh.n_rows == int(scene.sphere_valid.sum()) and bvh.depth <= 12
    n_slots = packed["sph24"].shape[1]
    bg = tmk.pack_bg(scene)
    for bounce in range(5):
        if bounce:
            tmk.bounce_steps_reference(st, keys, packed["sph24"], bg,
                                       k_steps=1, max_depth=50, t_min=1e-3,
                                       moving=scene.has_moving)
        time = st[6].contiguous() if scene.has_moving else None
        (_, fam, _), nodes, slots = _same(st[0:3], st[3:6], time, packed)
        assert (fam == 0).sum() >= 32 and (fam == -1).any()
        # The walk's point: a few dozen tests a ray, not a scan of all.
        assert nodes.float().mean() < 40 and slots.float().mean() < 16
        assert int(slots.max()) < n_slots


def _ground_rays(packed, n=4096, seed=1):
    """Rays leaving the radius-1000 ground sphere's surface near the
    spheres, in every direction of the upper hemisphere and skimming
    it."""
    g = np.random.default_rng(seed)
    xz = g.uniform(-12.0, 12.0, (2, n))
    y = -1000.0 + np.sqrt(1000.0 ** 2 - xz[0] ** 2 - xz[1] ** 2)
    o = np.stack([xz[0], y, xz[1]]).astype(np.float32)
    d = g.normal(size=(3, n))
    d[1] = np.abs(d[1]) * np.where(np.arange(n) % 4 == 0, 1e-4, 1.0)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


def _grazing_rays(packed, n=4096, seed=2, far=(2.0, 30.0)):
    """Rays whose line passes each small sphere's center at its radius,
    times 1 +- a few 1e-7, from origins `far` units away."""
    g = np.random.default_rng(seed)
    sph = packed["sph24"].numpy().astype(np.float64)
    slots = np.nonzero((sph[7] > 0.5) & (np.abs(sph[18]) < 2.0))[0]
    pick = slots[g.integers(0, slots.size, n)]
    c, r = sph[0:3, pick], np.abs(sph[18, pick])
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    side = np.cross(d.T, g.normal(size=(n, 3))).T
    side /= np.linalg.norm(side, axis=0)
    miss = r * (1.0 + g.uniform(-4e-7, 4e-7, n))
    o = c + side * miss - d * g.uniform(*far, n)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def _far_rays(packed, n=4096, seed=5):
    """Grazing rays from 300-3000 units away, where the expanded
    quadratic's rounding moves a root by more than a small sphere's
    radius: the error the boxes' padding covers."""
    return _grazing_rays(packed, n, seed, far=(300.0, 3000.0))


HARD_RAYS = {"ground": _ground_rays, "grazing": _grazing_rays,
             "far": _far_rays}


@pytest.mark.parametrize("name", ["chap12", "book2chap2"])
@pytest.mark.parametrize("rays", ["ground", "grazing", "far"])
def test_walk_equals_scan_on_hard_rays(name, rays):
    scene, packed, _, _ = _camera_state(name)
    o, d = HARD_RAYS[rays](packed)
    time = (torch.from_numpy(np.random.default_rng(3).uniform(
        0.0, 1.0, o.shape[1]).astype(np.float32))
        if scene.has_moving else None)
    (_, fam, _), _, _ = _same(o, d, time, packed)
    assert (fam == 0).sum() >= 256


@pytest.mark.parametrize("name", ["chap12", "book2chap2"])
def test_every_root_lies_in_its_padded_box(name):
    """The walk may skip a box only if no slot inside it has a root
    there: every finite root of every slot, under the plain arithmetic,
    gives a point (float64) inside that slot's box padded by the ray's
    pad (accel.slot_boxes, RAY_PAD)."""
    scene, packed, st, keys = _camera_state(name)
    sph = packed["sph24"]
    lo, hi, valid = accel.slot_boxes(sph, packed["bvh"].shutter)
    hard = [make(packed) for make in HARD_RAYS.values()]
    o = torch.cat([st[0:3]] + [r[0] for r in hard], dim=1)
    d = torch.cat([st[3:6]] + [r[1] for r in hard], dim=1)
    n = o.shape[1]
    time = torch.from_numpy(np.random.default_rng(4).uniform(
        0.0, 1.0, n).astype(np.float32)) if scene.has_moving else None
    spheres = tmk._scene_from_packs(sph, None, scene.has_moving)
    roots = geometry.sphere_roots(spheres, o, d, time, 1e-3, geometry.INF)
    ray, slot = (roots < geometry.INF).nonzero(as_tuple=True)
    assert valid[slot.numpy()].all()
    t = roots[ray, slot].double()
    p = (o.double()[:, ray] + d.double()[:, ray] * t).numpy()
    pad = accel.RAY_PAD * o.double().abs().sum(0)[ray].numpy()
    lo_s, hi_s = lo[slot.numpy()].T, hi[slot.numpy()].T
    assert (p >= lo_s - pad).all() and (p <= hi_s + pad).all()
    assert ray.numel() >= 2000


def test_too_deep_or_too_large_raises(monkeypatch):
    """A tree deeper than the kernels' stack raises (chap12's is 8 deep:
    against a stack of 4 here), and so does a pack past the shared
    memory the kernels opt into. On the card the wrappers raise without
    a pack."""
    scene, cam = tscenes.SCENES["chap12"](W, H)
    sph12 = tmk.pack_spheres_full(scene)
    assert accel.pack_bvh(sph12).depth == 8
    monkeypatch.setattr(accel, "BVH_STACK", 4)
    with pytest.raises(ValueError, match="deep"):
        accel.pack_bvh(sph12)
    monkeypatch.undo()
    g = np.random.default_rng(0)
    sph = torch.zeros((24, 8192))
    sph[0:3] = torch.from_numpy(g.uniform(-50, 50, (3, 8192))
                                .astype(np.float32))
    sph[3], sph[18], sph[7] = 0.04, 0.2, 1.0
    sph[4] = 0.1  # moving: 36 bytes a row
    with pytest.raises(ValueError, match="shared memory"):
        accel.pack_bvh(sph, (0.0, 1.0))
    with pytest.raises(ValueError, match="shutter"):
        accel.pack_bvh(sph)
    with pytest.raises(ValueError, match="BVH"):
        tmk._check_bvh(None, sph, "intersect_only")


def _record_bounce_steps(monkeypatch):
    """Record the state (a copy) and BVH pack of every bounce_steps call;
    the calls run as before."""
    calls = []
    bounce_steps = tmk.bounce_steps

    def recorded(state, keys, sph24, bg8, **kw):
        calls.append(dict(state=state.detach().clone(), sph24=sph24.detach(),
                          bvh=kw["bvh"], moving=kw["moving"]))
        return bounce_steps(state, keys, sph24, bg8, **kw)

    monkeypatch.setattr(tmk, "bounce_steps", recorded)
    return calls


def _queue_render(name):
    """trace_queue on the scene at W x H, 1 spp, depth 8, 256 lanes for
    1,296 samples, one bounce step a refill."""
    scene, cam = tscenes.SCENES[name](W, H)
    cfg = render.RenderConfig(width=W, height=H, spp=1, max_depth=8,
                              queue_size=256, bounces_per_refill=1)
    ids = torch.arange(W * H)
    return scene, cam, render.trace_queue(scene, cam, ids % W, ids // W, cfg,
                                          0, 0, 1, device="cpu")


def _fused_trace(name, requires_grad=False):
    """trace_batch_fused on the scene's W x H camera rays at sample 0,
    depth 8 (chains of 4 and 5 steps). Returns (scene, o, time, rad)."""
    scene, cam = tscenes.SCENES[name](W, H)
    ids = torch.arange(W * H)
    keys = rng.sample_keys(rng.key_words(0), ids, 0)
    o, d, tm = render.generate_rays(cam, ids % W, ids // W, W, H, keys)
    o = o.requires_grad_(requires_grad)
    rad, _ = render.trace_batch_fused(scene, o, d, tm, keys, 8, 1e-3)
    return scene, o, tm, rad


def _walk_equals_scan_on(calls):
    """Every recorded call's lanes, live and dead (a dead lane keeps its
    last ray), through the walk of the calls' one pack and the scan, in
    one batch (the walk is a loop of small ops a node level)."""
    assert all(c["bvh"] is calls[0]["bvh"] for c in calls)
    st = torch.cat([c["state"] for c in calls], dim=1)
    time = st[6].contiguous() if calls[0]["moving"] else None
    (_, fam, _), _, _ = _same(st[0:3], st[3:6], time, dict(
        sph24=calls[0]["sph24"], bvh=calls[0]["bvh"]))
    for i in range(len(calls)):  # hits in every call's lanes
        n = calls[i]["state"].shape[1]
        assert (fam[i * n:(i + 1) * n] == 0).any()


@pytest.mark.parametrize("name", ["chap12", "book2chap2"])
def test_walk_equals_scan_on_queue_lanes(name, monkeypatch):
    """The queue's lanes at each launch: fresh camera rays beside lanes
    1-8 bounces into their paths, after refills (256 lanes for 1,296
    samples), with the pack trace_queue builds."""
    calls = _record_bounce_steps(monkeypatch)
    _queue_render(name)
    assert len(calls) >= 12
    # A fresh lane is alive at bounce 0; a lane mid-path has scattered.
    mid = [int((c["state"][13] > 0).sum()) for c in calls]
    fresh = [int(((c["state"][13] == 0)
                  & (c["state"][14] > 0.5)).sum()) for c in calls]
    assert max(mid) > 0 and sum(f > 0 and m > 0
                                for f, m in zip(fresh, mid)) >= 2
    _walk_equals_scan_on(calls)


@pytest.mark.parametrize("name", ["chap12", "book2chap2"])
def test_walk_equals_scan_on_chain_inputs(name, monkeypatch):
    """trace_batch_fused's chain inputs (camera rays, then the lanes
    after the first chain of 4 steps, compacted), with the pack it
    builds over the rays' own times."""
    calls = _record_bounce_steps(monkeypatch)
    scene, _, tm, _ = _fused_trace(name)
    assert len(calls) == 2
    shutter = (float(tm.min()), float(tm.max())) if scene.has_moving else None
    assert calls[0]["bvh"].shutter == shutter
    _walk_equals_scan_on(calls)


@pytest.mark.parametrize("name", ["chap12", "book2chap2"])
def test_chain_bvh_is_the_pack_over_the_rays_times(name):
    """render.chain_bvh, the pack trace_batch_fused builds from one read
    of the spheres and the times' range, is pack_bvh's over the rays'
    own shutter (none for a static scene)."""
    scene, cam = tscenes.SCENES[name](W, H)
    sph = tmk.pack_spheres_full(scene)
    tm = torch.rand(W * H, generator=torch.Generator().manual_seed(3))
    ours = render.chain_bvh(sph, tm, scene.has_moving)
    ref = accel.pack_bvh(sph, (float(tm.min()), float(tm.max()))
                         if scene.has_moving else None)
    assert ours.shutter == ref.shutter
    assert (ours.shutter is None) == (not scene.has_moving)
    # Bits: a node's w0 and w1 are int32 words, some of them NaN floats.
    assert torch.equal(ours.nodes.view(torch.int32),
                       ref.nodes.view(torch.int32))
    assert torch.equal(ours.rows, ref.rows)
    assert (ours.n_always, ours.depth, ours.n_slots) == (
        ref.n_always, ref.depth, ref.n_slots)


@pytest.mark.parametrize("driver", ["queue", "fused", "image"])
def test_drivers_build_one_pack_and_pass_it(driver, monkeypatch):
    """trace_queue and trace_batch_fused build one BVH pack a call (the
    queue over the camera's shutter, the chain over the rays' times),
    render_image(differentiable=True) one an image over the camera's
    shutter for all its tiles' chains, and each hands that same pack to
    every bounce_steps call and, backward, to every chain_adjoint
    call."""
    built, seen = [], []
    pack_bvh, chain_adjoint = accel.pack_bvh, tmkv.chain_adjoint

    def counted_pack(*args, **kwargs):
        built.append(args[1] if len(args) > 1 else kwargs.get("shutter"))
        return pack_bvh(*args, **kwargs)

    @functools.wraps(chain_adjoint)  # its launch and mismatch counts
    def counted_chain(*args, **kwargs):
        seen.append(("chain_adjoint", kwargs["bvh"]))
        return chain_adjoint(*args, **kwargs)

    monkeypatch.setattr(accel, "pack_bvh", counted_pack)
    monkeypatch.setattr(tmkv, "chain_adjoint", counted_chain)
    calls = _record_bounce_steps(monkeypatch)
    if driver == "queue":
        _queue_render("book2chap2")
        assert built == [(0.0, 1.0)]
    elif driver == "fused":
        _, o, tm, rad = _fused_trace("book2chap2", requires_grad=True)
        rad.sum().backward()
        assert len(built) == 1
        assert o.grad is not None and o.grad.abs().max() > 0
        assert [w for w, _ in seen] == ["chain_adjoint"] * 2
    else:
        scene, cam = tscenes.SCENES["book2chap2"](16, 8)
        color = scene.tex_color1.clone().requires_grad_()
        cfg = render.RenderConfig(width=16, height=8, spp=2, max_depth=3,
                                  tile_pixels=64, samples_per_pass=2)
        img, _ = render.render_image(
            dataclasses.replace(scene, tex_color1=color), cam, cfg, 0,
            differentiable=True, device="cpu")
        img.sum().backward()
        assert built == [(0.0, 1.0)] and color.grad.abs().max() > 0
        assert len(seen) == len(calls) == 2  # two tiles, one chain each
    packs = [c["bvh"] for c in calls] + [b for _, b in seen]
    assert len(calls) >= 2 and all(b is packs[0] for b in packs)


def test_render_image_builds_one_pack_and_passes_it(monkeypatch):
    """render_image makes one BVH pack an image, over the camera's
    shutter, and every intersect_only call gets it."""
    built, seen = [], []
    pack_bvh, intersect = accel.pack_bvh, tmk.intersect_only

    def counted_pack(*args, **kwargs):
        built.append(args[1] if len(args) > 1 else kwargs.get("shutter"))
        return pack_bvh(*args, **kwargs)

    def counted_intersect(*args, **kwargs):
        seen.append(kwargs["bvh"])
        return intersect(*args, **kwargs)

    monkeypatch.setattr(accel, "pack_bvh", counted_pack)
    monkeypatch.setattr(tmk, "intersect_only", counted_intersect)
    scene, cam = tscenes.SCENES["book2chap2"](16, 8)
    cfg = render.RenderConfig(width=16, height=8, spp=2, max_depth=3,
                              tile_pixels=32, samples_per_pass=2)
    render.render_image(scene, cam, cfg, 0, device="cpu")
    assert len(built) == 1 and built[0] == (0.0, 1.0)
    assert seen and all(b is seen[0] for b in seen)
