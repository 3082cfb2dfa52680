"""Differentiable rendering: parameter partitioning and the train step.

The counterpart of rrt_tpu's `diff.py` on the train kernels
(ops/megakernel_train.TileTrainChain):

  * `partition` extracts the float leaves of SceneArrays as a dict of
    optimizable parameters (integer id and valid tables stay frozen);
  * `make_train_step` builds a step: differentiable render -> MSE loss
    -> gradients of the parameters and of all nine Camera fields -> SGD.

Discrete sampling decisions (winners, roots, branches, checker parity)
are booleans replayed by the backward, so sampling is detached as
path-replay backprop prescribes: gradients flow only through continuous
quantities. Sharding (`mesh`) is ROADMAP Queue A #12.
"""

import dataclasses
import logging
import os

import torch

from .camera import Camera
from .ops import megakernel as ops_mega
from .ops import megakernel_train as ops_train
from .render import (DIFF_SAMPLE_BUDGET, RenderConfig, _check_device,
                     _check_diff_scope, _packs, _warn_diff_fallback,
                     diff_fallback_reason, render_image_diff)
from .rng import key_words
from .scene import SceneArrays

# Scene leaves that make sense to optimize (continuous scene parameters),
# as in rrt_tpu; sphere_dc (a moving sphere's motion) gets its gradient
# through the velocity pack rows; the families outside the sphere subset
# get none until they are ported (ROADMAP Queue A #9).
DIFFERENTIABLE_FIELDS = (
    "sphere_c0", "sphere_dc", "sphere_radius",
    "quad_q", "quad_u", "quad_v",
    "box_center", "box_half",
    "med_center", "med_radius", "med_half", "med_neg_inv_density",
    "mat_fuzz", "mat_ior",
    "tex_color1", "tex_color2", "tex_scale",
    "bg_bottom", "bg_top",
)

_log = logging.getLogger("rrt_tpu_torch.diff")


def partition(scene: SceneArrays) -> dict:
    """Extract the optimizable float leaves."""
    return {f: getattr(scene, f) for f in DIFFERENTIABLE_FIELDS}


def combine(scene: SceneArrays, params: dict) -> SceneArrays:
    return dataclasses.replace(scene, **params)


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "sharded training (mesh) is not ported to rrt_tpu_torch yet "
            "(ROADMAP Queue A #12)")


def render_loss(params: dict, camera: Camera, scene: SceneArrays, target,
                cfg: RenderConfig, seed, mesh=None, *, device):
    """MSE between a differentiable render and a target image (H,W,3)."""
    _no_mesh(mesh)
    img, _ = render_image_diff(combine(scene, params), camera, cfg, seed,
                               device=device)
    return torch.mean((img - target) ** 2)


def _residual_budget_bytes(device) -> int:
    """Device memory one train launch's residual may take. Half the free
    memory of the card (torch.cuda.mem_get_info), or of the host for
    the CPU; RRT_RESIDUAL_BUDGET_GB overrides it."""
    env = os.environ.get("RRT_RESIDUAL_BUDGET_GB")
    if env:
        return int(float(env) * 1e9)
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return free // 2


def resolve_spp_chunk(cfg: RenderConfig, spp_chunk: int | None = None,
                      *, device) -> int:
    """The chunked trainer's samples per chunk: a divisor of cfg.spp
    whose residual (ops_train.boundary_residual_bytes) fits the budget
    (_residual_budget_bytes). Without a request it is cfg.spp when that
    fits (one chunk, no re-render), otherwise the largest admissible
    divisor; a request is honoured, or adjusted to the largest
    admissible divisor below it with a one-time warning."""
    budget = _residual_budget_bytes(device)
    n_pix = cfg.width * cfg.height
    chunk = min(spp_chunk, cfg.spp) if spp_chunk else cfg.spp
    eff = next((c for c in range(chunk, 0, -1) if cfg.spp % c == 0
                and ops_train.boundary_residual_bytes(n_pix, c) <= budget),
               None)
    if eff is None:
        raise ValueError(
            f"no admissible spp chunk: even one sample's residual at "
            f"{cfg.width}x{cfg.height} exceeds the {budget / 1e9:.3f} GB "
            "budget (RRT_RESIDUAL_BUDGET_GB raises it)")
    if spp_chunk and eff != spp_chunk:
        _warn_chunk_adjusted(spp_chunk, eff, budget)
    return eff


_warned_chunks: set = set()


def _warn_chunk_adjusted(requested: int, effective: int, budget: int):
    """One warning per (requested, effective) pair per process."""
    key = (requested, effective)
    if key not in _warned_chunks:
        _warned_chunks.add(key)
        _log.warning("requested spp_chunk=%d adjusted to %d (the chunk "
                     "must divide cfg.spp and its residual fit the "
                     "%.1f GB budget)", requested, effective, budget / 1e9)


def _leaves(scene: SceneArrays, camera: Camera, device):
    """Fresh gradient leaves on `device`: (scene on device with its
    parameters replaced by the leaves, params, camera)."""
    params = {k: v.detach().to(device).requires_grad_()
              for k, v in partition(scene).items()}
    cam = Camera(**{f.name: getattr(camera, f.name).detach().to(device)
                    .requires_grad_() for f in dataclasses.fields(Camera)})
    return combine(scene.to(device), params), params, cam


def _sgd(scene, camera, gp, gc, lr, device):
    with torch.no_grad():
        scene = scene.to(device)
        new_p = {k: getattr(scene, k) - lr * gp[k] for k in gp}
        new_c = Camera(**{
            f.name: getattr(camera, f.name).to(device) - lr * gc[i]
            for i, f in enumerate(dataclasses.fields(Camera))})
    return combine(scene, new_p), new_c


def _grads(out, params, camera, cot=None):
    """Gradients of `out` (with cotangent `cot`) for the parameter dict
    and the nine camera fields; zeros where none flows."""
    leaves = list(params.values()) + [getattr(camera, f.name)
                                      for f in dataclasses.fields(Camera)]
    gs = torch.autograd.grad(out, leaves, cot, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g
          for x, g in zip(leaves, gs)]
    return dict(zip(params, gs[:len(params)])), gs[len(params):]


def field_grads(scene: SceneArrays, camera: Camera, cfg: RenderConfig,
                d_sph24, d_cam24, d_bg8, *, device):
    """The gradients of the partition() fields and of the nine Camera
    fields that the pack cotangents (d_sph24, d_cam24, d_bg8) stand for:
    the VJP of the packing. Returns (dict, list of nine tensors)."""
    scene_d, params, cam = _leaves(scene, camera, device)
    return _grads(_packs(scene_d, cam, cfg, device), params, cam,
                  (d_sph24, d_cam24, d_bg8))


def loss_and_grads(cfg: RenderConfig, scene: SceneArrays, camera: Camera,
                   target, seed, *, device):
    """The one-shot step's work before its update: (loss, gradients of
    the partition() fields (dict), gradients of the nine Camera fields
    (list)) of the MSE render loss."""
    scene_d, params, cam = _leaves(scene, camera, device)
    loss = render_loss(params, cam, scene_d, target.to(device), cfg, seed,
                       device=device)
    gp, gc = _grads(loss, params, cam)
    return loss.detach(), gp, gc


def loss_and_grads_chunked(cfg: RenderConfig, scene: SceneArrays,
                           camera: Camera, target, seed,
                           spp_chunk: int | None = None, *, device):
    """loss_and_grads in sample chunks (resolve_spp_chunk), exploiting
    the image's linearity in per-chunk radiance:

      pass 1  chunk 0 through TileTrainChain (its residual kept across
              the cotangent barrier) and the other chunks through the
              forward kernel alone (render_tiles) -> image;
      pass 2  loss and d(loss)/d(radiance sums);
      pass 3  chunk 0's backward on its kept residual; every other
              chunk runs one train_fwd + one train_bwd seeded with the
              same cotangent; gradients add up.

    Its gradient is the one-shot one on the same keys, up to f32
    summation order."""
    _check_diff_scope("make_train_step_chunked", scene, cfg)
    scene_d, params, cam = _leaves(scene, camera, device)
    chunk = resolve_spp_chunk(cfg, spp_chunk, device=device)

    def chain(lo):
        rad, _ = ops_train.TileTrainChain.apply(
            *_packs(scene_d, cam, cfg, device), key_words(seed), lo,
            cfg.width, cfg.height, chunk, cfg.max_depth, cfg.t_min,
            scene.has_moving)
        return rad

    rad0 = chain(0)
    rad_sum = rad0.detach()
    with torch.no_grad():
        packs = _packs(scene_d, cam, cfg, device)
        for lo in range(chunk, cfg.spp, chunk):
            r, _ = ops_mega.render_tiles(
                *packs, seed_words=key_words(seed), sample_lo=lo,
                width=cfg.width, height=cfg.height, spp=chunk,
                max_depth=cfg.max_depth, t_min=cfg.t_min,
                moving=scene.has_moving)
            rad_sum = rad_sum + r
    rs = rad_sum.requires_grad_()
    img = rs.reshape(cfg.height, cfg.width, 3) / float(cfg.spp)
    loss = torch.mean((img - target.to(device)) ** 2)
    (cot,) = torch.autograd.grad(loss, rs)
    gp, gc = _grads(rad0, params, cam, cot)
    del rad0  # chunk 0's residual goes before the next chunk's
    for lo in range(chunk, cfg.spp, chunk):
        dgp, dgc = _grads(chain(lo), params, cam, cot)
        gp = {k: gp[k] + dgp[k] for k in gp}
        gc = [a + b for a, b in zip(gc, dgc)]
    return loss.detach(), gp, gc


def make_train_step_chunked(cfg: RenderConfig, lr: float = 1e-2,
                            spp_chunk: int | None = None, mesh=None, *,
                            device):
    """Full-spp MSE training step through loss_and_grads_chunked, then
    SGD on the parameters and the camera. Returns step(scene, camera,
    target, seed) -> (scene', camera', loss)."""
    _no_mesh(mesh)
    device = _check_device(device)

    fallback = []

    def step(scene: SceneArrays, camera: Camera, target, seed):
        # As rrt_tpu: a scene or depth the train kernels do not take
        # runs the one-shot step (render_image_diff's route), with one
        # log line naming why.
        reason = diff_fallback_reason(scene, cfg)
        if reason is not None:
            _warn_diff_fallback("make_train_step_chunked", reason)
            if not fallback:
                fallback.append(_make_train_step_oneshot(cfg, lr,
                                                         device=device))
            return fallback[0](scene, camera, target, seed)
        loss, gp, gc = loss_and_grads_chunked(cfg, scene, camera, target,
                                              seed, spp_chunk, device=device)
        return (*_sgd(scene, camera, gp, gc, lr, device), loss)

    return step


def make_train_step(cfg: RenderConfig, lr: float = 1e-2, mesh=None, *,
                    device):
    """Full training step: differentiable render + backward + SGD update
    of the parameters and the camera. Sample budgets beyond
    4 * DIFF_SAMPLE_BUDGET go through make_train_step_chunked, as in
    rrt_tpu. Returns step(scene, camera, target, seed) ->
    (scene', camera', loss)."""
    _no_mesh(mesh)
    if cfg.spp > 4 * DIFF_SAMPLE_BUDGET:
        return make_train_step_chunked(cfg, lr=lr, device=device)
    return _make_train_step_oneshot(cfg, lr, device=device)


def _make_train_step_oneshot(cfg: RenderConfig, lr: float, *, device):
    device = _check_device(device)

    def step(scene: SceneArrays, camera: Camera, target, seed):
        loss, gp, gc = loss_and_grads(cfg, scene, camera, target, seed,
                                      device=device)
        return (*_sgd(scene, camera, gp, gc, lr, device), loss)

    return step
