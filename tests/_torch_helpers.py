"""Helpers shared by the port's CPU test files that hold rrt_tpu_torch
against rrt_tpu: rrt_tpu's dataclasses as numpy leaves and as the port's
scene and camera, the gradient leaves and their gradients, the two
gradient rules, the batch drivers' configurations, and the fixture that
runs rrt_tpu's Pallas kernels in interpret mode. Import it as a module
(`import _torch_helpers as helpers`), the fixture by name."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import rrt_tpu.ops.megakernel as jmk
import rrt_tpu.ops.megakernel_vjp as jmkv
from rrt_tpu import render as jrender
from rrt_tpu import scenes as jscenes
from rrt_tpu_torch import convert, diff, render

@pytest.fixture(scope="module")
def interpret_pallas():
    """rrt_tpu's megakernels run in Pallas interpret mode on the CPU."""
    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    mp.setattr(jmk.pl, "pallas_call", interp)
    mp.setattr(jmkv.pl, "pallas_call", interp)
    yield
    mp.undo()


def leaves(obj):
    """A dataclass's fields as numpy arrays."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def port(j_scene, j_cam):
    """rrt_tpu's scene and camera as the port's."""
    return (convert.scene_from_numpy(leaves(j_scene)),
            convert.camera_from_numpy(leaves(j_cam)))


def port_scene(name, width, height):
    """rrt_tpu's scene `name` at width x height, as the port's."""
    return port(*jscenes.SCENES[name](width, height))


def chap12_small():
    """chap12 at 16x8, as the port's."""
    return port(*jscenes.chap12_scene(16, 8))


def grad_leaves(scene, cam):
    """Fresh leaves that require gradients: (partition(scene), camera)."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    camera = dataclasses.replace(cam, **{
        f.name: getattr(cam, f.name).detach().clone().requires_grad_()
        for f in dataclasses.fields(cam)})
    return params, camera


def field_grads(out, params, camera, cot=None):
    """The gradients of `out` (a scalar loss, or a tensor with its
    cotangent `cot`, a numpy array) by grad_leaves' leaves, as numpy:
    {partition() field or "camera." + Camera field: gradient}, zeros
    where `out` does not depend on a leaf."""
    fields = list(params.values()) + [getattr(camera, f.name)
                                      for f in dataclasses.fields(camera)]
    gs = torch.autograd.grad(
        out, fields, None if cot is None else torch.from_numpy(cot),
        allow_unused=True)
    gs = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
          for x, g in zip(fields, gs)]
    names = list(params) + ["camera." + f.name
                            for f in dataclasses.fields(camera)]
    return dict(zip(names, gs))


def jax_grads(vjp, cot):
    """rrt_tpu's gradients from a vjp of (partition(scene), camera), as
    field_grads names them."""
    gp, gc = vjp(jnp.asarray(cot))
    out = {k: np.asarray(v) for k, v in gp.items()}
    out.update({"camera." + f.name: np.asarray(getattr(gc, f.name))
                for f in dataclasses.fields(gc)})
    return out


def assert_grads_close(got, exp, *, share=1.0, cam_slack=0.0):
    """test_mk_grad's rule: partition() fields within 2e-3 of their
    largest gradient (for tables above 64 elements on at least `share`
    of the elements), Camera fields within 3e-2 of their own plus
    `cam_slack` of the largest Camera gradient."""
    cam_max = max(np.abs(v).max() for k, v in exp.items()
                  if k.startswith("camera."))
    for k, b in exp.items():
        a = got[k]
        assert np.isfinite(a).all(), k
        if k.startswith("camera."):
            atol = 3e-2 * max(np.abs(b).max(), 1e-4) + cam_slack * cam_max
            assert (np.abs(a - b) <= atol).all(), (k, a, b)
            continue
        close = np.abs(a - b) <= 2e-3 * max(np.abs(b).max(), 1e-4)
        if a.size > 64:
            assert close.mean() >= share, (k, close.mean())
        else:
            assert close.all(), (k, a, b)


def assert_fields_close(got, exp, tol, cam_tol):
    """Each partition() field within tol of its largest gradient; each
    Camera field within cam_tol of the largest camera gradient."""
    cam_max = max(np.abs(v).max() for k, v in exp.items()
                  if k.startswith("camera."))
    for k in exp:
        assert np.isfinite(got[k]).all(), k
        if k.startswith("camera."):
            atol = cam_tol * max(np.abs(exp[k]).max(), cam_max)
        else:
            atol = tol * max(np.abs(exp[k]).max(), 1e-6)
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=atol,
                                   err_msg=k)


def batch_cfgs(size, **kw):
    """rrt_tpu's and the port's RenderConfig for the batch drivers' tests:
    size (width, height, spp and max_depth), 432-pixel tiles of 2
    samples a pass, then kw. At 48x27 three tiles, and 1296 = 3 x 432,
    so rrt_tpu pads no pixel (its n_traced counts the segments of
    padding repeats; the port's last tile is ragged instead)."""
    base = dict(size, tile_pixels=432, samples_per_pass=2)
    base.update(kw)
    return jrender.RenderConfig(**base), render.RenderConfig(**base)
