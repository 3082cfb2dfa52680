"""The Cornell box's gradients through the train chain against rrt_tpu's
scan, on the CPU (tests/test_torch_cornell_grad.py holds the rest of
ROADMAP Queue A #9.7's backwards).

trace_tiles_diff runs the train kernels' plain versions on the CPU
(megakernel_train.render_tiles_train_reference, tiles_adjoint_reference);
rrt_tpu's trace_batch(differentiable=True) with explicit keys
(tests/test_torch_train.py's pattern) is the reference, on cornell (six
quads, two boxes rotated about Y, a light) and on
scenes.book2.mixed_scene, at 12x12, 2 spp, depth 4. The pixels whose
radiance parts by 1e-3 get loss weight 0, also when they part under a
grey background, which shows a path that leaves a black scene in one
package only; at least 98.5% must agree, and quad_q, quad_u, quad_v,
box_center, box_half, tex_color1 (the albedos and the light's emission)
and bg_bottom lie within 2e-3 of each field's largest gradient. On
cornell, whose textures are solid under a black background, the quads'
and boxes' positions get no gradient; on the mixed scene rays leave
them for the spheres and the sky, and quad_q's and box_center's
gradients are not 0 in either package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu import diff as jdiff
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import Camera as JCamera
from rrt_tpu.camera import generate_rays as jgenerate_rays
from rrt_tpu.render import trace_batch as jtrace_batch
from rrt_tpu.scene import SceneBuilder as JBuilder
from rrt_tpu_torch import convert, diff, render
from rrt_tpu_torch.scenes import book2

FIELDS = ("quad_q", "quad_u", "quad_v", "box_center", "box_half",
          "tex_color1", "bg_bottom")
MIX = np.array([1.0, 0.7, 0.3], np.float32)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _both(name, w, h):
    """(rrt_tpu's scene and camera, the port's carried across)."""
    if name == "mixed":
        j_scene, j_cam = book2.mixed_scene(w, h, JBuilder, JCamera)
    else:
        j_scene, j_cam = jscenes.SCENES[name](w, h)
    return (j_scene, j_cam), (convert.scene_from_numpy(_leaves(j_scene)),
                              convert.camera_from_numpy(_leaves(j_cam)))


def _field_grads(out, params, cot):
    gs = torch.autograd.grad(out, list(params.values()), cot,
                             allow_unused=True)
    return {k: np.zeros(v.shape, np.float32) if g is None else g.numpy()
            for (k, v), g in zip(params.items(), gs)}


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_train_gradients_match_reference(name):
    """trace_tiles_diff (the train chain's plain versions) against
    rrt_tpu's scan with explicit keys, the loss sum(sin(0.1 i) MIX .
    radiance) over the agreeing pixels."""
    w, h, spp, depth = 12, 12, 2, 4
    (j_scene, j_cam), (scene, cam) = _both(name, w, h)
    ids = jnp.arange(w * h, dtype=jnp.int32)
    px, py = ids % w, ids // w

    def j_rad(params):
        s = jdiff.combine(j_scene, params)
        tot = jnp.zeros((w * h, 3), jnp.float32)
        for samp in range(spp):
            keys = jrng.sample_keys(jax.random.key(0),
                                    (py * w + px).astype(jnp.uint32), samp)
            o, d, tm = jgenerate_rays(j_cam, px, py, w, h, keys)
            r, _ = jtrace_batch(s, o, d, tm, keys, depth, 1e-3,
                                differentiable=True)
            tot = tot + jnp.stack([r.x, r.y, r.z], axis=-1)
        return tot

    j_params = jdiff.partition(j_scene)
    j_rad = jax.jit(j_rad)
    ref, vjp = jax.vjp(j_rad, j_params)
    ref = np.asarray(ref)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    rad, _ = render.trace_tiles_diff(diff.combine(scene, params), cam, cfg,
                                     0, device="cpu")
    # Cornell's background is black, so a path that leaves the box in one
    # package and not in the other may render the same radiance: the
    # pixels are also compared with a grey background, which shows it.
    grey = np.full(3, 0.5, np.float32)
    lit = np.asarray(j_rad(dict(j_params, bg_bottom=jnp.asarray(grey))))
    lit_t, _ = render.trace_tiles(diff.combine(scene, {
        "bg_bottom": torch.from_numpy(grey)}), cam, cfg, 0, device="cpu")
    agree = ((np.abs(rad.detach().numpy() - ref) < 1e-3)
             & (np.abs(lit_t.numpy() - lit) < 1e-3)).all(axis=1)
    assert agree.mean() >= 0.985, agree.mean()
    wm = (np.sin(np.arange(w * h) * 0.1)[:, None] * MIX * agree[:, None]) \
        .astype(np.float32)
    (gj,) = vjp(jnp.asarray(wm))
    got = _field_grads(rad, params, torch.from_numpy(wm))
    light = int(scene.mat_tex[scene.quad_mat[int(np.flatnonzero(
        scene.mat_type[scene.quad_mat[:scene.n_quads_active]].numpy()
        == 3)[0])]])
    assert np.abs(np.asarray(gj["tex_color1"])[light]).max() > 0
    if name == "mixed":
        for k in ("quad_q", "box_center"):
            assert np.abs(np.asarray(gj[k])).max() > 0, k
            assert np.abs(got[k]).max() > 0, k
    for k in FIELDS:
        a, b = got[k], np.asarray(gj[k])
        assert np.isfinite(a).all(), k
        atol = 2e-3 * max(np.abs(b).max(), 1e-4)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)
