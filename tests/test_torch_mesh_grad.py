"""The port's sharded gradients against rrt_tpu's, on the CPU.

Ranks are gloo processes started by parallel.launch with a free port and
a time limit, each running python -m rrt_tpu_torch.parallel.train_step
on chap11 at 16x8, 4 spp (every pixel of the two packages' renders
agrees there: the loss is one MSE over the whole image, so a pixel
whose path parts between them would move every gradient). rrt_tpu's
reference is jax.value_and_grad of its diff.render_loss on a 2x2 mesh of
conftest's virtual CPU devices: on the CPU its sharded route is the
bounce scan under shard_map (render_image_sharded(differentiable=True);
its train kernels need a TPU), drawing the same (pixel, sample) keys.

  * depth 4: the port's one-shot step (the train kernels' plain
    versions on each rank's band) and its chunked trainer, on 2x2;
  * depth 64: past the train kernels' 64 bounce records, render_loss
    takes the batch driver's chain on every rank
    (render_image_sharded(differentiable=True): replicate_leaves and
    _SumOverWorld's identity transpose), on 2x1 and 1x2.

Every rank's loss within 1e-5 relative of rrt_tpu's and its gradients
by test_mk_grad's rule (helpers.assert_grads_close: each partition()
field within 2e-3 of its largest gradient, each Camera field within
3e-2 of its own), and not world-size times them: the gradients' total
magnitude within 1e-3 of rrt_tpu's."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_helpers as helpers
from rrt_tpu import diff as jdiff
from rrt_tpu import render as jrender
from rrt_tpu import scenes as jscenes
from rrt_tpu.parallel import mesh as jmesh
from rrt_tpu_torch import render, scenes as tscenes
from rrt_tpu_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE, W, H, SPP = "chap11", 16, 8, 4
CHAIN = "render_image_diff_sharded: using the batch driver's differentiable"


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def reference():
    """rrt_tpu's (loss, gradients) at a depth, on its 2x2 mesh, from the
    target train_step renders (the port's tile image at seed 1) and the
    start it takes (the spheres' radii scaled by 1.01)."""
    cache = {}

    def get(depth):
        if depth not in cache:
            cfg = render.RenderConfig(width=W, height=H, spp=SPP,
                                      max_depth=depth)
            target, _ = render.render_image_tiles(
                *tscenes.SCENES[SCENE](W, H), cfg, 1, device="cpu")
            scene, cam = jscenes.SCENES[SCENE](W, H)
            scene = dataclasses.replace(
                scene, sphere_radius=scene.sphere_radius * 1.01)
            jcfg = jrender.RenderConfig(width=W, height=H, spp=SPP,
                                        max_depth=depth,
                                        tile_pixels=W * H // 2,
                                        samples_per_pass=1)
            mesh = jmesh.make_mesh(jax.devices()[:4], dp=2, sp=2)
            loss, (gp, gc) = jax.value_and_grad(
                jdiff.render_loss, argnums=(0, 1))(
                jdiff.partition(scene), cam, scene,
                jnp.asarray(target.numpy()), jcfg, 0, mesh)
            grads = {k: np.asarray(v) for k, v in gp.items()}
            grads.update({"camera." + f.name: np.asarray(getattr(gc, f.name))
                          for f in dataclasses.fields(gc)})
            cache[depth] = float(loss), grads
        return cache[depth]

    return get


def _sharded_step(tmp_path, mesh, depth, *extra):
    """Each rank's train_step output and log."""
    dp, sp = map(int, mesh.split("x"))
    logs = launch(["rrt_tpu_torch.parallel.train_step", "--scene", SCENE,
                   "-r", f"{W}x{H}", "-s", str(SPP), "--max-depth",
                   str(depth), "--device", "cpu", "--mesh", mesh, "--out",
                   str(tmp_path), *extra], dp * sp, timeout=240, env=_env(),
                  cwd=REPO)
    return [dict(np.load(tmp_path / f"rank{i}.npz"))
            for i in range(dp * sp)], logs


def _check(ranks, reference):
    loss, want = reference
    for r in ranks:
        got = {k[len("grad/"):]: v for k, v in r.items()
               if k.startswith("grad/")}
        assert float(r["loss"]) == pytest.approx(loss, rel=1e-5)
        assert np.abs(want["sphere_radius"]).max() > 0
        helpers.assert_grads_close(got, want)
        total = sum(np.abs(v).sum() for v in got.values())
        assert abs(total / sum(np.abs(v).sum() for v in want.values())
                   - 1.0) < 1e-3
    for k in (k for k in ranks[0] if k.startswith("param/")):
        assert all(np.array_equal(r[k], ranks[0][k]) for r in ranks), k


@pytest.mark.parametrize("trainer", ["oneshot", "chunked"])
def test_sharded_step_matches_rrt_tpu(tmp_path, reference, trainer):
    """The 2x2 step through the train kernels' plain versions: one-shot
    (render_loss) and chunked in chunks of 2 samples (one a rank)."""
    extra = ["--spp-chunk", "2"] if trainer == "chunked" else []
    ranks, logs = _sharded_step(tmp_path, "2x2", 4, *extra)
    assert not any(CHAIN in log for log in logs)
    _check(ranks, reference(4))


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_sharded_chain_route_matches_rrt_tpu(tmp_path, reference, mesh):
    """Depth 64: every rank's render_loss takes the bounce chain."""
    ranks, logs = _sharded_step(tmp_path, mesh, 64)
    assert all(CHAIN in log for log in logs)
    _check(ranks, reference(64))
