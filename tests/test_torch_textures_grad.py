"""The perlin and image textures' gradients against rrt_tpu, on the CPU:
diff_step's marble and image branches, the train chain's and the bounce
chain's plain versions, the atlas cotangent.

rrt_tpu's eager code takes a sphere's texture angles from exact arccos
and arctan2 where the port's kernels and plain versions take rrt_tpu's
kernel polynomials (geometry.sphere_uv), so a ray at a texel's edge may
read another texel in each package: such rays part in radiance, and
their pixels get loss weight 0, as the pixels whose radiance parts by
1e-3 do (ROADMAP Queue C). Earth's image here is random, so that a
parted texel shows in radiance. At least 98.5% of the pixels must
agree, and the fields lie within 2e-3 of each field's largest gradient
(gradcheck.sample_agreement's rule for long paths is not needed at
depth 4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu import diff as jdiff
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import generate_rays as jgenerate_rays
from rrt_tpu.ops import megakernel as jmk
from rrt_tpu.ops import megakernel_vjp as jmkv
from rrt_tpu.render import trace_batch as jtrace_batch
from rrt_tpu_torch import convert, diff, render
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_vjp as tmkv
from rrt_tpu_torch.scene import TEX_PERLIN

MIX = np.array([1.0, 0.7, 0.3], np.float32)
FIELDS = ("sphere_c0", "sphere_radius", "tex_color1", "tex_scale",
          "bg_bottom", "bg_top")


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _random_earth(w, h, seed=3):
    img = np.random.default_rng(seed).uniform(
        0.05, 0.95, (16, 32, 3)).astype(np.float32)
    return jscenes.book2.earth_scene(w, h, image=img)


def _both(name, w, h):
    """(rrt_tpu's scene and camera, the port's carried across)."""
    j_scene, j_cam = (_random_earth(w, h) if name == "earth"
                      else jscenes.SCENES[name](w, h))
    return (j_scene, j_cam), (convert.scene_from_numpy(_leaves(j_scene)),
                              convert.camera_from_numpy(_leaves(j_cam)))


def _j_radiance(j_scene, j_cam, w, h, spp, depth):
    """rrt_tpu's scan with explicit keys: radiance sums (P, 3) as a
    function of (partition params, images)."""
    ids = jnp.arange(w * h, dtype=jnp.int32)
    px, py = ids % w, ids // w

    def rad(params, images):
        s = dataclasses.replace(jdiff.combine(j_scene, params),
                                images=images)
        tot = jnp.zeros((w * h, 3), jnp.float32)
        for samp in range(spp):
            keys = jrng.sample_keys(jax.random.key(0),
                                    (py * w + px).astype(jnp.uint32), samp)
            o, d, tm = jgenerate_rays(j_cam, px, py, w, h, keys)
            r, _ = jtrace_batch(s, o, d, tm, keys, depth, 1e-3,
                                differentiable=True)
            tot = tot + jnp.stack([r.x, r.y, r.z], axis=-1)
        return tot

    return jax.jit(rad)


def _check_fields(got, gj, fields):
    for k in fields:
        a, b = got[k], np.asarray(gj[k])
        assert np.isfinite(a).all(), k
        atol = 2e-3 * max(np.abs(b).max(), 1e-4)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)


def _weights(rad, ref, w, h):
    agree = (np.abs(rad - ref) < 1e-3).all(axis=1)
    assert agree.mean() >= 0.985, agree.mean()
    return (np.sin(np.arange(w * h) * 0.1)[:, None] * MIX
            * agree[:, None]).astype(np.float32)


# The reference render's size: rrt_tpu's jit of its scan and of its vjp
# takes most of this file's time, so both chains' tests share one of
# each a scene (the `reference` fixture).
W, H, SPP, DEPTH = 12, 8, 2, 4


@pytest.fixture(scope="module")
def reference():
    """Per scene: (rrt_tpu's scene, the port's scene and camera, rrt_tpu's
    radiance sums and the vjp of its render in (params, images))."""
    out = {}

    def get(name):
        if name not in out:
            (j_scene, j_cam), (scene, cam) = _both(name, W, H)
            j_rad = _j_radiance(j_scene, j_cam, W, H, SPP, DEPTH)
            ref, vjp = jax.vjp(j_rad, jdiff.partition(j_scene),
                               j_scene.images)
            out[name] = (j_scene, scene, cam, np.asarray(ref), vjp)
        return out[name]

    return get


def _port_grads(rad, params, ref, vjp):
    """The loss weights of the agreeing pixels, and both packages'
    partition() gradients of sum(weights . radiance)."""
    wm = _weights(rad.detach().numpy(), ref, W, H)
    gj, _ = vjp(jnp.asarray(wm))
    gs = torch.autograd.grad(rad, list(params.values()),
                             torch.from_numpy(wm), allow_unused=True)
    got = {k: np.zeros(v.shape, np.float32) if g is None else g.numpy()
           for (k, v), g in zip(params.items(), gs)}
    return got, gj


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_train_chain_gradients_match_reference(name, reference):
    """trace_tiles_diff (the train kernels' plain versions) against
    rrt_tpu's scan, the loss sum(sin(0.1 i) MIX . radiance) over the
    agreeing pixels: the spheres' centers and radii, color1 (the light's
    and the marble's), the marble's texture scale and the background;
    the marble's scale and color1 get a gradient in both packages."""
    _, scene, cam, ref, vjp = reference(name)
    cfg = render.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    rad, _ = render.trace_tiles_diff(diff.combine(scene, params), cam, cfg,
                                     0, device="cpu")
    got, gj = _port_grads(rad, params, ref, vjp)
    if name == "simple_light":
        marble = int(np.flatnonzero(scene.tex_type.numpy() == TEX_PERLIN)[0])
        for k in ("tex_scale", "tex_color1"):
            assert np.abs(np.asarray(gj[k])[marble]).max() > 0, k
            assert np.abs(got[k][marble]).max() > 0, k
    _check_fields(got, gj, FIELDS)


def _atlas_case(reference):
    """earth's loss weights and jax.grad of rrt_tpu's render in its
    images (the vjp's second output)."""
    _, scene, cam, ref, vjp = reference("earth")
    cfg = render.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    rad, _ = render.trace_tiles(scene, cam, cfg, 0, device="cpu")
    wm = _weights(rad.numpy(), ref, W, H)
    _, g_ref = vjp(jnp.asarray(wm))
    return scene, cam, cfg, wm, np.asarray(g_ref)


def test_train_chain_atlas_cotangent_matches_jax_grad(reference):
    """The train chain's atlas cotangent (TileTrainChain's d_atlas, from
    tiles_adjoint's plain version) against jax.grad of rrt_tpu's render
    with respect to images, on earth (a random image): the cotangent
    reaches the texels the agreeing paths read, and nothing else."""
    scene, cam, cfg, wm, g_ref = _atlas_case(reference)
    tex = tmk.pack_textures(scene)
    atlas = tex.atlas.clone().requires_grad_()
    packs = render._packs(scene, cam, cfg, "cpu")
    from rrt_tpu_torch.ops import megakernel_train as tmkt
    rad, _ = tmkt.TileTrainChain.apply(
        *packs, (0, 0), 0, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
        cfg.t_min, False, *tmkv.solid_inputs(
            None, dataclasses.replace(tex, atlas=atlas)))
    (g,) = torch.autograd.grad(rad, atlas, torch.from_numpy(wm))
    got = g[:, :3].reshape(g_ref.shape).numpy()
    assert np.abs(g_ref).max() > 0
    assert (g[:, 3] == 0).all()
    np.testing.assert_allclose(got, g_ref, rtol=0,
                               atol=1e-5 * np.abs(g_ref).max())


def test_chain_atlas_cotangent_matches_jax_grad(reference):
    """The bounce chain's (render_image(differentiable=True): bounce_steps
    forward, chain_bwd backward, their plain versions here) atlas
    cotangent, taken through the atlas leaf of trace_batch_fused's
    TexPack, against jax.grad of rrt_tpu's render."""
    scene, cam, cfg, wm, g_ref = _atlas_case(reference)
    images = scene.images.clone().requires_grad_()
    cfg = dataclasses.replace(cfg, samples_per_pass=cfg.spp)
    img, _ = render.render_image(dataclasses.replace(scene, images=images),
                                 cam, cfg, 0, differentiable=True,
                                 device="cpu")
    rad = img.reshape(-1, 3) * float(cfg.spp)
    (g,) = torch.autograd.grad(rad, images, torch.from_numpy(wm))
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=0,
                               atol=1e-5 * np.abs(g_ref).max())


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_chain_gradients_match_reference(name, reference):
    """render_image(differentiable=True) (the bounce chain) against
    rrt_tpu's scan, as the train chain's test."""
    _, scene, cam, ref, vjp = reference(name)
    cfg = render.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH,
                              samples_per_pass=SPP)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    img, _ = render.render_image(diff.combine(scene, params), cam, cfg, 0,
                                 differentiable=True, device="cpu")
    rad = img.reshape(-1, 3) * float(SPP)
    got, gj = _port_grads(rad, params, ref, vjp)
    _check_fields(got, gj, FIELDS)


def _step_inputs(seed, n):
    """One bounce on a marble sphere (from the outside) and one on a
    quad with an image texture, as rrt_tpu's _make_diff_step and the
    port's diff_step take them: state rows, the winner's sphere column
    and quad column in rrt_tpu's frame layout, the background, the
    atlas, and the replayed constants."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    o = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                  np.full(n, 6.0)]).astype(f32)
    target = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                       np.zeros(n)]).astype(f32)
    d = (target - o).astype(f32)
    return o, d


@pytest.mark.parametrize("kind", ["marble", "image"])
def test_diff_step_texture_branches_match_rrt_tpu(kind):
    """diff_step's marble and image branches under autograd against
    rrt_tpu's _make_diff_step under jax.vjp: a sphere of radius 2 at the
    origin, hit from z = 6 (the near root), lambertian, its texture a
    marble of scale 4 (cotangents to the center, radius, color1, the
    texture scale in its row 17 and the ray) or an image read at a
    replayed texel (the atlas's cotangent at that texel, which rrt_tpu's
    one-hot contraction rounds to bf16)."""
    n, ah, aw = jmk.TN, 4, 8  # rrt_tpu's step takes one tile of lanes
    o, d = _step_inputs(5, n)
    rng = np.random.default_rng(6)
    f32 = np.float32
    col = np.zeros((24, n), f32)
    col[3] = 4.0  # r^2
    col[7] = 1.0
    col[10:13] = np.array([0.8, 0.6, 0.4], f32)[:, None]
    col[16] = 2.0 if kind == "marble" else 3.0
    col[17] = 4.0
    col[18] = 2.0
    # The forward's t: the near root.
    b = (o * d).sum(0)
    a = (d * d).sum(0)
    t_hit = ((-b - np.sqrt(b * b - a * ((o * o).sum(0) - 4.0))) / a).astype(
        f32)
    texel = rng.integers(0, ah * aw, n)
    atlas = rng.uniform(0.1, 0.9, (ah * aw, 4)).astype(f32)
    atlas[:, 3] = 0.0
    draws = [rng.normal(size=n).astype(f32) for _ in range(6)]
    draws.append(np.zeros(n, f32))
    ones, zeros = np.ones(n, bool), np.zeros(n, bool)
    c = dict(t_hit=t_hit, hit=ones, miss=zeros, survives=ones, front=ones,
             degen=zeros, do_reflect=zeros, use_c2=zeros, is_lam=ones,
             is_met=zeros, is_die=zeros, is_light=zeros,
             is_per=np.full(n, kind == "marble"),
             is_img=np.full(n, kind == "image"), texel=texel,
             xi=texel % aw, img_row=texel // aw, draws=draws,
             is_sky=np.bool_(True))
    state = [*o, *d, np.zeros(n, f32), *(np.full(n, 0.9, f32),) * 3,
             *(np.zeros(n, f32),) * 3]
    bg6 = [np.full((), x, f32) for x in (1, 1, 1, 0.5, 0.7, 1.0)]
    cot = rng.normal(size=(13, n)).astype(f32)

    # rrt_tpu: row layout (1, TN) with its channel-major atlas.
    j_atlas = np.transpose(atlas[:, :3].reshape(1, ah, aw, 3),
                           (0, 1, 3, 2)).reshape(ah, 3 * aw)
    jc = {k: jnp.asarray(v)[None] if np.ndim(v) == 1 else (
        [jnp.asarray(x)[None] for x in v] if k == "draws" else jnp.asarray(v))
        for k, v in c.items()}
    g = jmkv._make_diff_step(
        jc, moving=False, has_quads=False, has_boxes=False,
        has_rot_boxes=False, has_perlin=kind == "marble",
        has_images=kind == "image", img_ah=ah, img_aw=aw)
    j_ins = [jnp.asarray(x)[None] for x in state] + [jnp.asarray(col)] + [
        jnp.asarray(x) for x in bg6] + (
        [jnp.asarray(j_atlas)] if kind == "image" else [])
    j_out, j_vjp = jax.vjp(g, *j_ins)
    j_g = j_vjp(tuple(jnp.asarray(x)[None] for x in cot))

    t_ins = [torch.from_numpy(x).requires_grad_() for x in state]
    t_col = torch.from_numpy(col).requires_grad_()
    t_bg = [torch.tensor(float(x)).requires_grad_() for x in bg6]
    t_atlas = torch.from_numpy(atlas).requires_grad_()
    tc = {k: (torch.from_numpy(np.asarray(v)) if k != "draws"
              else tuple(torch.from_numpy(x) for x in v))
          for k, v in c.items()}
    tc["is_sky"] = torch.tensor(True)
    out = tmkv.diff_step(tc, *t_ins, t_col, *t_bg,
                         *((t_atlas,) if kind == "image" else ()),
                         moving=False, has_perlin=kind == "marble",
                         has_images=kind == "image")
    for a_, b_ in zip(out, j_out):
        np.testing.assert_allclose(a_.detach().numpy(), np.asarray(b_)[0],
                                   rtol=1e-5, atol=1e-5)
    leaves = t_ins + [t_col] + ([t_atlas] if kind == "image" else [])
    t_g = torch.autograd.grad(out, leaves, [torch.from_numpy(x) for x in cot],
                              allow_unused=True)
    for i in range(13):
        want = np.asarray(j_g[i])[0]
        got = np.zeros(n, f32) if t_g[i] is None else t_g[i].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-4 * max(np.abs(want).max(), 1.0),
                                   err_msg=f"state row {i}")
    want_col = np.asarray(j_g[13])
    got_col = t_g[13].numpy()
    for row in (0, 1, 2, 3, 10, 11, 12, 17, 18):
        np.testing.assert_allclose(
            got_col[row], want_col[row], rtol=2e-4,
            atol=2e-4 * max(np.abs(want_col[row]).max(), 1e-3),
            err_msg=f"sphere row {row}")
    if kind == "marble":
        assert np.abs(got_col[17]).max() > 0
    else:
        want_a = np.asarray(j_g[-1]).reshape(ah, 3, aw).transpose(0, 2, 1)
        got_a = t_g[-1].numpy()
        # rrt_tpu's vjp of its one-hot contraction rounds each pass's
        # cotangent to bf16 (8 bits), so its atlas is within 2^-8 of each
        # contribution.
        np.testing.assert_allclose(got_a[:, :3].reshape(ah, aw, 3), want_a,
                                   rtol=0, atol=1e-2 * np.abs(want_a).max())
        assert (got_a[:, 3] == 0).all()
