"""The tile-render kernel's packs, its wrapper and its plain version.

`render_tiles` renders every pixel's samples in one launch of the CUDA
kernel in csrc/tile_render.cu, the counterpart of rrt_tpu's
`ops/megakernel.py::_tile_render_kernel`. For tensors on the CPU it
runs `render_tiles_reference`, the same function in plain PyTorch.

The kernel reads the scene as packs, laid out as in rrt_tpu:

Sphere pack, f32 (24, S):
  0-2 motion base | 3 r^2 (-1 on invalid slots) | 4-6 motion vel
  | 7 valid | 8 mat_type | 9 aux (fuzz or ior) | 10-12 color1
  | 13-15 color2 | 16 tex_type | 17 tex_scale | 18 signed radius
  | 19 image index | 20-23 pad
Camera pack, f32 (24,):
  0-2 origin | 3-5 lower_left | 6-8 horizontal | 9-11 vertical
  | 12-14 u | 15-17 v | 18 lens_radius | 19 time0 | 20 time1-time0
  | 21 W | 22 H | 23 H-1
Background pack, f32 (8,): bottom rgb | top rgb | mode | pad

The sphere pack keeps the scene's own slot count (a multiple of 128):
unlike the TPU kernel, the GPU kernel has no tile width to pad to.
"""

import torch

from .. import rng
from . import _build
from ..camera import thin_lens_rays
from ..scene import MAT_DIELECTRIC, SceneArrays, tensor_fields

# Shared memory holds the intersection rows (0-3) of every slot, 16
# bytes a slot, inside the 48 KB a block gets without opting in.
MAX_SLOTS = 3072


def check_scope(scene: SceneArrays, rr_depth: int = 0):
    """Raise NotImplementedError for a scene or option the tile kernel
    does not cover yet, naming the ROADMAP item that ports it."""
    outside = (
        (scene.has_moving, "moving spheres", "#9.1"),
        (scene.has_quads, "quads", "#9.2"),
        (scene.has_emissive, "emissive materials", "#9.2"),
        (scene.has_boxes, "boxes", "#9.3"),
        (scene.has_media, "constant media", "#9.4"),
        (scene.has_perlin, "perlin textures", "#9.5"),
        (scene.has_images, "image textures", "#9.5"),
        (rr_depth > 0, "Russian roulette (rr_depth > 0)", "#9.6"),
    )
    for flag, what, item in outside:
        if flag:
            raise NotImplementedError(
                f"{what}: outside the rrt_tpu_torch tile kernel's scope "
                f"(ROADMAP Queue A {item})")


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def pack_spheres_full(scene: SceneArrays):
    """(24, S) f32 sphere pack (layout in the module docstring); each
    slot's material and texture are resolved at pack time."""
    inv_dt = scene.sphere_inv_dt
    base = scene.sphere_c0 - (scene.sphere_t0 * inv_dt)[:, None] \
        * scene.sphere_dc
    vel = inv_dt[:, None] * scene.sphere_dc
    radius = scene.sphere_radius
    r2 = torch.where(scene.sphere_valid, radius * radius, -1.0)
    mat = scene.sphere_mat.long()
    mtype = scene.mat_type[mat]
    aux = torch.where(mtype == MAT_DIELECTRIC, scene.mat_ior[mat],
                      scene.mat_fuzz[mat])
    tex = scene.mat_tex[mat].long()
    f32 = torch.float32
    return torch.cat([
        base.T, r2[None], vel.T, scene.sphere_valid.to(f32)[None],
        mtype.to(f32)[None], aux[None], scene.tex_color1[tex].T,
        scene.tex_color2[tex].T, scene.tex_type[tex].to(f32)[None],
        scene.tex_scale[tex][None], radius[None],
        scene.tex_image[tex].to(f32)[None],
        torch.zeros((4, radius.shape[0]), dtype=f32, device=radius.device),
    ], dim=0).contiguous()


def pack_camera(camera, width: int, height: int):
    """(24,) f32 camera pack: the derived thin-lens frame + jitter
    scales (layout in the module docstring)."""
    origin, lower_left, horizontal, vertical, u, v = camera.basis()
    lens = torch.stack([camera.aperture * 0.5, camera.time0,
                        camera.time1 - camera.time0])
    size = camera.aperture.new_tensor(
        [float(width), float(height), float(height - 1)])
    return torch.cat([origin, lower_left, horizontal, vertical, u, v,
                      lens, size]).to(torch.float32)


def pack_bg(scene: SceneArrays):
    """(8,) f32 background pack: bottom rgb, top rgb, mode, pad."""
    return torch.cat([
        scene.bg_bottom, scene.bg_top,
        scene.bg_mode.to(torch.float32)[None],
        torch.zeros((1,), dtype=torch.float32,
                    device=scene.bg_top.device)])


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def _check_inputs(sph24, cam24, bg8, width, height, spp, max_depth):
    packs = (("sph24", sph24), ("cam24", cam24), ("bg8", bg8))
    for name, t in packs:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != sph24.device:
            raise ValueError(f"{name} is on {t.device}, sph24 on "
                             f"{sph24.device}")
    if sph24.dim() != 2 or sph24.shape[0] != 24 or sph24.shape[1] < 1:
        raise ValueError(f"sph24 must be (24, S), got {tuple(sph24.shape)}")
    if tuple(cam24.shape) != (24,) or tuple(bg8.shape) != (8,):
        raise ValueError(f"cam24 must be (24,) and bg8 (8,), got "
                         f"{tuple(cam24.shape)} and {tuple(bg8.shape)}")
    if width < 1 or height < 1 or spp < 1 or max_depth < 0:
        raise ValueError(f"bad render size {width}x{height} spp={spp} "
                         f"max_depth={max_depth}")


def render_tiles(sph24, cam24, bg8, *, seed_words, sample_lo: int,
                 width: int, height: int, spp: int, max_depth: int,
                 t_min: float):
    """Render samples [sample_lo, sample_lo + spp) of every pixel.

    sph24 (24,S), cam24 (24,) and bg8 (8,) are the packs, all on one
    device; seed_words: the (s0, s1) u32 key words of the seed.
    Returns (radiance sums (P,3) f32 in scan-line order, traced-ray
    counts (P,) int32), P = width * height, on the packs' device.

    CUDA tensors launch the kernel (and count the launch in
    `render_tiles.launches`); CPU tensors run render_tiles_reference."""
    _check_inputs(sph24, cam24, bg8, width, height, spp, max_depth)
    kw = dict(seed_words=seed_words, sample_lo=sample_lo, width=width,
              height=height, spp=spp, max_depth=max_depth, t_min=t_min)
    device = sph24.device
    if device.type == "cpu":
        return render_tiles_reference(sph24, cam24, bg8, **kw)
    if device.type != "cuda":
        raise ValueError(f"render_tiles runs on cuda or cpu, not {device}")
    n_slots = sph24.shape[1]
    if n_slots > MAX_SLOTS:
        raise ValueError(f"{n_slots} sphere slots exceed the kernel's "
                         f"{MAX_SLOTS}")
    lib = _build.load()
    n_pix = width * height
    rad = torch.empty((n_pix, 3), dtype=torch.float32, device=device)
    traced = torch.empty((n_pix,), dtype=torch.int32, device=device)
    s0, s1 = rng._seed_words(tuple(seed_words))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rrt_tile_render(
            sph24.data_ptr(), n_slots, cam24.data_ptr(), bg8.data_ptr(),
            s0, s1, sample_lo & rng.MASK32, width, height, spp, max_depth,
            t_min, rad.data_ptr(), traced.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("tile_render launch failed: "
                           + lib.rrt_error_string(err).decode())
    render_tiles.launches += 1
    return rad, traced


render_tiles.launches = 0


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _scene_from_packs(sph24, bg8) -> SceneArrays:
    """The sphere scene the packs describe, with one material and one
    texture per slot (the pack holds each slot's resolved material)."""
    dev = sph24.device
    n = sph24.shape[1]
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    mtype = sph24[8].to(torch.int32)
    is_die = mtype == MAT_DIELECTRIC
    empty = {name: torch.zeros((0,), device=dev) for name in tensor_fields()
             if name.startswith(("quad_", "box_", "med_"))}
    return SceneArrays(
        sphere_c0=sph24[0:3].T, sphere_dc=torch.zeros((n, 3), device=dev),
        sphere_t0=torch.zeros((n,), device=dev),
        sphere_inv_dt=torch.ones((n,), device=dev),
        sphere_radius=sph24[18], sphere_mat=slots,
        sphere_valid=sph24[7] > 0.5,
        mat_type=mtype, mat_tex=slots,
        mat_fuzz=torch.where(is_die, 0.0, sph24[9]),
        mat_ior=torch.where(is_die, sph24[9], 1.0),
        tex_type=sph24[16].to(torch.int32), tex_color1=sph24[10:13].T,
        tex_color2=sph24[13:16].T, tex_scale=sph24[17],
        tex_image=sph24[19].to(torch.int32),
        images=torch.zeros((1, 1, 1, 3), device=dev),
        bg_mode=bg8[6].to(torch.int32), bg_bottom=bg8[0:3],
        bg_top=bg8[3:6], n_spheres_active=n, **empty)


def render_tiles_reference(sph24, cam24, bg8, *, seed_words,
                           sample_lo: int, width: int, height: int,
                           spp: int, max_depth: int, t_min: float,
                           chunk: int = 1 << 18):
    """Plain PyTorch version of `render_tiles`, same inputs and outputs.

    A wavefront loop over (pixel, sample) rays, `chunk` rays at a time in
    sample-major order, built from the port's camera, geometry,
    materials and textures through render._shade. Rays that die are
    dropped from the batch after each bounce. A chunk holds at most one
    sample of each pixel, so radiance is summed into each pixel in the
    kernel's order: sample by sample, bounce by bounce."""
    from ..render import _shade  # render imports this module

    dev = sph24.device
    scene = _scene_from_packs(sph24, bg8)
    basis = tuple(cam24[3 * i:3 * i + 3] for i in range(6))
    n_pix = width * height
    n_rays = n_pix * spp
    chunk = min(chunk, n_pix)
    rad = torch.zeros((3, n_pix), dtype=torch.float32, device=dev)
    traced = torch.zeros((n_pix,), dtype=torch.int32, device=dev)
    for lo in range(0, n_rays, chunk):
        ray = torch.arange(lo, min(lo + chunk, n_rays), device=dev)
        pix = ray % n_pix
        keys = rng.sample_keys(tuple(seed_words), pix,
                               sample_lo + ray // n_pix)
        o, d, _ = thin_lens_rays(basis, cam24[18], cam24[19], cam24[20],
                                 pix % width, pix // width, width, height,
                                 keys)
        thr = torch.ones_like(o)
        for bounce in range(max_depth + 1):
            alive = torch.ones_like(pix, dtype=torch.bool)
            contrib, o, d, att, survives = _shade(
                scene, o, d, keys, bounce, alive, t_min, max_depth)
            rad[:, pix] += thr * contrib
            traced[pix] += 1
            thr = torch.where(survives, thr * att, thr)
            keep = survives.nonzero()[:, 0]
            if keep.numel() == 0:
                break
            pix, keys, o, d, thr = (pix[keep], keys[:, keep], o[:, keep],
                                    d[:, keep], thr[:, keep])
    return rad.T.contiguous(), traced
