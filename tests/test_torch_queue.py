"""The queue driver: its state, the bounce-steps kernel's plain version
and the driver end to end, against rrt_tpu.

bounce_steps_reference against rrt_tpu's bounce_steps (its Pallas
kernel in interpret mode, as tests/test_megakernel.py runs it) on the
same packed state: the rule of tests/test_megakernel.py's multi-step
test. A near-tie winner flip in an early step sends a lane down another
path, after which its bounce and traced counts part too, so alive
agrees on at least 98% of lanes; on those, traced and bounce are equal
and throughput and pending radiance agree within 1e-3 on at least 97%.

The driver: rrt_tpu's render_image_queue runs jit-compiled, the port's
op by op. On diffuse (lambertian only) nothing is near a tie, so the
images agree within 1e-5 and the traced totals exactly, the rule of
tests/test_queue.py. On chap12 XLA's fusion alone makes rrt_tpu part
from its own eager bounce on 0.85-1.56% of pixels (by shape), so the
rule of tests/test_torch_slice.py holds: 98.5% of pixels within 1e-3,
traced totals within 1%. The port's queue and tile drivers trace the same
paths through the same plain physics, so they agree within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import rrt_tpu.ops.megakernel as jmk
from rrt_tpu import render as jrender
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import generate_rays
from rrt_tpu.vec import V3
from rrt_tpu_torch import convert, render, rng, scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk

W, H = 32, 18


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


def _camera_state(name="chap12", n=1024, seed=0):
    """rrt_tpu's scene, its packed camera-ray state (16, n) and keys
    (2, n) u32 for pixels 0..n-1 (wrapping) at sample 0."""
    j_scene, j_cam = jscenes.SCENES[name](W, H)
    ids = jnp.arange(n, dtype=jnp.int32)
    px, py = ids % W, (ids // W) % H
    keys = jrng.sample_keys(jax.random.key(seed),
                            (py * W + px).astype(jnp.uint32), 0)
    o, d, tm = generate_rays(j_cam, px, py, W, H, keys)
    st = jmk.pack_state(o, d, tm, V3.ones((n,)), V3.zeros((n,)),
                        jnp.zeros((n,), jnp.int32), jnp.ones((n,), bool),
                        jnp.zeros((n,)))
    return j_scene, st, keys


def _port_inputs(j_scene, st, keys):
    t_scene = convert.scene_from_numpy(_leaves(j_scene))
    return (torch.from_numpy(np.array(st)),
            torch.from_numpy(np.asarray(keys).view(np.int32).copy()),
            tmk.pack_spheres_full(t_scene), tmk.pack_bg(t_scene))


@pytest.mark.parametrize("k_steps", [1, 4])
def test_bounce_steps_matches_reference(interpret_pallas, k_steps):
    j_scene, st, keys = _camera_state()
    ref = np.asarray(jmk.bounce_steps(
        st, keys, jmk.pack_spheres_full(j_scene),
        jnp.zeros((24, jmk.TS), jnp.float32), jmk.pack_media(j_scene),
        jmk.pack_bg(j_scene), k_steps=k_steps, moving=False,
        has_quads=False, n_media=0, max_depth=50, t_min=1e-3))
    state, kbits, sph, bg = _port_inputs(j_scene, st, keys)
    out = tmk.bounce_steps_reference(state, kbits, sph, bg, k_steps=k_steps,
                                     max_depth=50, t_min=1e-3,
                                     moving=False).numpy()
    assert float(ref[15].sum()) >= 1024  # every lane traced a segment
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    assert agree.mean() >= 0.98, agree.mean()
    np.testing.assert_array_equal(out[15][agree], ref[15][agree])
    np.testing.assert_array_equal(out[13][agree], ref[13][agree])
    close = np.all(np.abs(out[7:13] - ref[7:13]) < 1e-3, axis=0)[agree]
    assert close.mean() >= 0.97, close.mean()


def test_state_rows_match_reference():
    """pack_state / unpack_state keep rrt_tpu's row order."""
    rg = np.random.default_rng(0)
    n = 40
    o, d, thr, pend = (rg.standard_normal((3, n)).astype(np.float32)
                       for _ in range(4))
    tm = rg.random(n).astype(np.float32)
    bounce = rg.integers(0, 50, n).astype(np.int32)
    alive = rg.random(n) > 0.5
    traced = rg.integers(0, 9, n).astype(np.float32)
    ref = jmk.pack_state(V3(*o), V3(*d), tm, V3(*thr), V3(*pend), bounce,
                         alive, traced)
    t = torch.from_numpy
    st = tmk.pack_state(t(o), t(d), t(tm), t(thr), t(pend), t(bounce),
                        t(alive), t(traced))
    np.testing.assert_array_equal(st.numpy(), np.asarray(ref))
    back = tmk.unpack_state(st)
    for got, want in zip(back, (o, d, tm, thr, pend, bounce, alive,
                                traced)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrapper_updates_in_place_without_launch():
    j_scene, st, keys = _camera_state(n=256)
    state, kbits, sph, bg = _port_inputs(j_scene, st, keys)
    expect = tmk.bounce_steps_reference(state.clone(), kbits, sph, bg,
                                        k_steps=2, max_depth=8, t_min=1e-3,
                                        moving=False)
    before = tmk.bounce_steps.launches
    out = tmk.bounce_steps(state, kbits, sph, bg, k_steps=2, max_depth=8,
                           t_min=1e-3, moving=False)
    assert tmk.bounce_steps.launches == before
    assert out is state and torch.equal(state, expect)


def test_dead_lanes_pass_through():
    j_scene, _, keys = _camera_state(n=256)
    state = torch.zeros((16, 256))
    state[3:6] = 1.0
    state[15] = 7.0  # traced counts must survive
    _, kbits, sph, bg = _port_inputs(j_scene, np.zeros((16, 256),
                                                       np.float32), keys)
    before = state.clone()
    tmk.bounce_steps(state, kbits, sph, bg, k_steps=3, max_depth=50,
                     t_min=1e-3, moving=False)
    assert torch.equal(state, before)


@pytest.mark.parametrize("bad", ["state_rows", "keys_dtype", "lanes",
                                 "contiguous"])
def test_bounce_steps_rejects_bad_inputs(bad):
    j_scene, st, keys = _camera_state(n=256)
    state, kbits, sph, bg = _port_inputs(j_scene, st, keys)
    if bad == "state_rows":
        state = state[:15].contiguous()
    elif bad == "keys_dtype":
        kbits = rng.from_u32_bits(kbits)
    elif bad == "lanes":
        kbits = kbits[:, :128].contiguous()
    else:
        state = torch.cat([state, state], dim=1)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        tmk.bounce_steps(state, kbits, sph, bg, k_steps=1, max_depth=8,
                         t_min=1e-3, moving=False)


@pytest.mark.parametrize("bounce", [0, 1])
def test_intersect_only_matches_reference(interpret_pallas, bounce):
    """Camera rays (bounce 0) and the reference's own first-bounce rays:
    fam and idx equal on at least 99% of rays (the rest would be near-tie
    flips), misses' t equal. The hits' t: the expanded sphere quadratic
    cancels (the radius-1000 ground, small spheres 10 units from the
    camera), and XLA's jit evaluates it with other rounding than the
    port's op-by-op PyTorch, so t agrees within 1e-5 relative on only
    80-90% of these rays (measured) and within 1e-3 on all but the rare
    grazing ray: the rule is 1e-3 on 99%. The card test holds the CUDA
    kernel to its plain version within 1e-5: both round every product
    (-fmad=false)."""
    j_scene, st, keys = _camera_state()
    sph = jmk.pack_spheres_full(j_scene)
    if bounce:
        st = jmk.bounce_steps(
            st, keys, sph, jnp.zeros((24, jmk.TS), jnp.float32),
            jmk.pack_media(j_scene), jmk.pack_bg(j_scene), k_steps=1,
            moving=False, has_quads=False, n_media=0, max_depth=50,
            t_min=1e-3)
    rays8 = jnp.concatenate([st[0:7], st[13:14]], axis=0)
    t, fam, idx = (np.asarray(a) for a in jmk.intersect_only(
        rays8, keys, sph, jnp.zeros((24, jmk.TS), jnp.float32),
        jmk.pack_media(j_scene), moving=False, has_quads=False, n_media=0,
        t_min=1e-3))
    t_scene = convert.scene_from_numpy(_leaves(j_scene))
    rays = torch.from_numpy(np.array(rays8))
    tt, tf, ti = tmk.intersect_only(rays[0:3], rays[3:6],
                                    tmk.pack_spheres_full(t_scene),
                                    t_min=1e-3)
    assert tf.dtype == torch.int32 and ti.dtype == torch.int32
    same = (tf.numpy() == fam) & (ti.numpy() == idx)
    assert same.mean() >= 0.99, same.mean()
    assert (fam == 0).sum() >= 256 and (fam == -1).any()
    hit = same & (fam == 0)
    rel = np.abs(tt.numpy()[hit] - t[hit]) / t[hit]
    assert (rel < 1e-3).mean() >= 0.99, np.sort(rel)[-5:]
    miss = same & (fam == -1)
    np.testing.assert_array_equal(tt.numpy()[miss], t[miss])


# ---------------------------------------------------------------------------
# The driver end to end
# ---------------------------------------------------------------------------

# The drivers render at 48x27, where rrt_tpu's eager-vs-jit spread on
# chap12 (2 spp) is 0.85% of pixels (32x16: 1.17%, 32x18: 1.56%).
DW, DH, SPP, DEPTH = 48, 27, 4, 8


def _cfgs(**kw):
    base = dict(width=DW, height=DH, spp=SPP, max_depth=DEPTH,
                queue_size=2048)
    base.update(kw)
    return jrender.RenderConfig(**base), render.RenderConfig(**base)


# chap12 at 2 spp: the sample count at which tests/test_torch_slice.py
# measured rrt_tpu's own eager-vs-jit spread (a pixel of 4 samples holds
# a divergent one twice as often).
SCENE_SPP = {"diffuse": SPP, "chap12": 2}


@pytest.fixture(scope="module")
def reference_queue():
    """rrt_tpu's queue renders, one per scene, shared by the tests."""
    out = {}
    for name, spp in SCENE_SPP.items():
        j_scene, j_cam = jscenes.SCENES[name](DW, DH)
        img, n = jrender.render_image_queue(j_scene, j_cam,
                                            _cfgs(spp=spp)[0], 0)
        out[name] = (np.asarray(img), float(n))
    return out


def _port_queue(name, **kw):
    scene, cam = tscenes.SCENES[name](DW, DH)
    img, n = render.render_image_queue(scene, cam, _cfgs(**kw)[1], 0,
                                       device="cpu")
    return img.numpy(), int(n)


def test_queue_diffuse_matches_reference(reference_queue):
    ref, n_ref = reference_queue["diffuse"]
    img, n = _port_queue("diffuse")
    assert img.shape == (DH, DW, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, atol=1e-5, rtol=1e-5)
    assert n == n_ref


def test_queue_chap12_matches_reference(reference_queue):
    ref, n_ref = reference_queue["chap12"]
    img, n = _port_queue("chap12", spp=SCENE_SPP["chap12"])
    close = np.abs(img - ref).max(axis=2) < 1e-3
    assert close.mean() >= 0.985, close.mean()
    assert abs(n - n_ref) / n_ref < 1e-2


@pytest.mark.parametrize("name", ["diffuse", "chap12"])
def test_queue_matches_tile_driver(name):
    scene, cam = tscenes.SCENES[name](DW, DH)
    cfg = _cfgs()[1]
    tile, n_tile = render.render_image_tiles(scene, cam, cfg, 0,
                                             device="cpu")
    img, n = _port_queue(name)
    np.testing.assert_allclose(img, tile.numpy(), atol=1e-5, rtol=1e-5)
    assert n == int(n_tile)


def test_queue_size_invariance():
    """Per-sample radiance is the same for any queue size; only the
    order of the sums into a pixel changes."""
    imgs = [_port_queue("chap11", queue_size=q) for q in (512, 2048, 8192)]
    for img, n in imgs[1:]:
        np.testing.assert_allclose(img, imgs[0][0], atol=1e-5, rtol=1e-5)
        assert n == imgs[0][1]


def test_queue_counts_outer_steps():
    """A sample range smaller than the queue, and the step counter: at
    least one outer step per bounces_per_refill of the longest path."""
    scene, cam = tscenes.SCENES["diffuse"](DW, DH)
    cfg = _cfgs()[1]
    ids = torch.arange(DW * DH)
    before = render.trace_queue.outer_steps
    rad, n = render.trace_queue(scene, cam, ids % DW, ids // DW, cfg, 0, 1, 3,
                                queue_size=1 << 20, device="cpu")
    assert render.trace_queue.outer_steps - before >= 1
    tiles, n_t = render.trace_tiles(scene, cam, cfg, 0, sample_lo=1,
                                    n_samples=2, device="cpu")
    torch.testing.assert_close(rad, tiles, atol=1e-5, rtol=1e-5)
    assert int(n) == int(n_t)
