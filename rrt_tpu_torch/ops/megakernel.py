"""The forward kernels' packs, wrappers and plain versions.

Three CUDA kernels, each beside its plain PyTorch version, which tensors
on the CPU run instead (the kernels walk the sphere pack's BVH,
rrt_tpu_torch/accel.py, which their callers build once a pack; the
plain versions scan, the same function):

  `render_tiles`   every pixel's samples in one launch
                   (csrc/tile_render.cu), the counterpart of rrt_tpu's
                   `ops/megakernel.py::_tile_render_kernel`; plain
                   version `render_tiles_reference`;
  `bounce_steps`   K bounce steps of the queue driver's (16, Q) lane
                   state (csrc/queue.cu), the counterpart of
                   `_bounce_megakernel`; plain `bounce_steps_reference`;
  `intersect_only` the closest hit of each ray for the batch driver
                   (csrc/queue.cu), the counterpart of
                   `_intersect_kernel` (spheres, quads, media), with a
                   box family that rrt_tpu's lacks; plain
                   `intersect_only_reference`.

The kernel reads the scene as packs, laid out as in rrt_tpu but for the
quad pack, which keeps each quad's corner and edges (the kernels derive
its plane frame, rrt_tpu's rows 0-12, from them: geometry.quad_frames):

Sphere pack, f32 (24, S) (rows 8-19 a slot's resolved material and
texture):
  0-2 motion base | 3 r^2 (-1 on invalid slots) | 4-6 motion vel
  | 7 valid | 8 mat_type | 9 aux (fuzz or ior) | 10-12 color1
  | 13-15 color2 | 16 tex_type | 17 tex_scale | 18 signed radius
  | 19 image index | 20-23 pad
Camera pack, f32 (24,):
  0-2 origin | 3-5 lower_left | 6-8 horizontal | 9-11 vertical
  | 12-14 u | 15-17 v | 18 lens_radius | 19 time0 | 20 time1-time0
  | 21 W | 22 H | 23 H-1
Background pack, f32 (8,): bottom rgb | top rgb | mode | pad
Quad pack, f32 (24, Q):
  0-2 q | 3-5 u | 6-8 v | 9 valid | 10 mat_type | 11 aux | 12-14 color1
  | 15-17 color2 | 18 tex_type | 19 tex_scale | 20 image index
  | 21-23 pad (rrt_tpu overloads color2.r with the image index; this
  layout has the room)
Box pack, f32 (24, B), rrt_tpu's:
  0-2 center | 3-5 half (0 on invalid slots) | 6 cos | 7 sin (the
  world-from-box Y rotation) | 8 valid | 9 mat_type | 10 aux
  | 11-13 color1 | 14-16 color2 | 17 tex_type | 18 tex_scale | 19-23 pad
Medium pack, f32 (D, 24), rrt_tpu's, a row a medium slot:
  0 boundary type (0 sphere, 1 box) | 1-3 center | 4 radius | 5-7 half
  | 8-16 world-from-box rotation, row major | 17 -1/density | 18 valid
  | 19-21 the isotropic albedo (its texture's color1) | 22-23 pad
Atlas, f32 (I * AH * AW, 4) (`TexPack`, `pack_textures`): the scene's
  images (SceneArrays.images, (I, AH, AW, 3), one grid), a texel a row
  of rgb and a zero, row (image * AH + y) * AW + x: a lookup is one
  16-byte load from device memory (earth's 128x256 stand-in is 512 KB,
  past a block's shared memory; it stays in L2), and the backward adds
  an albedo's cotangent to its texel with one four-float atomic. The
  TPU's (I * AH, 3 * AW) channel-major layout served its one-hot MXU
  contraction, which a GPU does not need.

Every pack keeps the scene's own slot count (a multiple of 128): unlike
the TPU kernel, the GPU kernel has no tile width to pad to. A scene with
quads, boxes, constant media or a diffuse_light hands the kernels its
quad, box and medium packs and their active slot counts (`SolidPacks`,
`pack_solids`), and they run their solid-family variant: the quads, then
the boxes, seeding the spheres' BVH walk; then every active medium, read
from its pack in device memory (no cap), against the closest solid's t,
each with its own STREAM_MEDIUM draw (a scene of media alone runs it
with no quad or box). The forward kernels, train_fwd and chain_bwd
walk a family of more than SOLID_CAP active slots over its tree
(`pack_solids`' accel.SolidBvh, built on the host once a render or a
differentiable call; the loop's (t, slot) bit for bit), staged in shared
memory after the rows (a scene whose rows and trees exceed what a block
may opt into raises before any launch), and loop over a smaller one;
train_bwd loops over any number (rttnw_final's 400 ground boxes).

A scene with perlin or image textures hands the kernels its TexPack,
and they run their texture variant (csrc/bounce.cuh kTex): the marble's
7 octaves of hashed-lattice noise and the atlas lookup at the winner's
uv (geometry.sphere_uv, quad_uv: rrt_tpu's kernel polynomials for the
sphere's angles). A scene without them passes None and runs the
variants as they were, which never compile the texture code.

A scene with moving spheres (`SceneArrays.has_moving`, the wrappers'
`moving=True`) runs each kernel's moving variant: a sphere's center at a
ray's time is base + time * vel (pack rows 0-2 and 4-6), and every ray
carries its time (the camera's shutter draw; state row 6). A static
scene runs the static variant, whose arithmetic reads no time.

Russian roulette (the wrappers' `rr_depth`, RenderConfig.rr_depth; 0
off) is a runtime argument of every shading kernel, not an
instantiation: from bounce rr_depth on, a path that scatters below
max_depth draws the STREAM_RR coin (rng.rr_draw) and goes on with
probability p = clip(max(thr * att), 0.05, 1), its throughput weighted
by 1 / p (render._apply_rr; csrc/bounce.cuh finish_bounce).
"""

import ctypes
import dataclasses

import torch

from .. import accel, rng
from . import _build
from ..camera import thin_lens_rays
from ..scene import (MAT_DIELECTRIC, MAT_ISOTROPIC, SceneArrays,
                     tensor_fields)

# Shared memory holds the intersection rows (0-3) of every slot, 16
# bytes a slot, inside the 48 KB a block gets without opting in.
MAX_SLOTS = 3072
# Active quads and boxes the kernels loop over (each; csrc/bounce.cuh
# kSolidCap). The forward kernels, train_fwd and chain_bwd walk a larger
# family's tree, train_bwd loops over any number.
SOLID_CAP = accel.SOLID_CAP
# Where a kernel's staged spheres, solid rows and solid trees past a
# block's shared memory are recorded.
FORWARD_SMEM_ITEM = 'Queue C, "A cap rrt_tpu does not have"'
# A winner as one int16 (train_fwd's residual, the backwards' records):
# a sphere's slot, QUAD_CODE + a quad's, BOX_CODE + a box's, MEDIUM_CODE
# + a medium's; -1 a miss (csrc/bounce.cuh kQuadCode, kBoxCode,
# kMediumCode, kCodeSpan). Each family after the spheres gets CODE_SPAN
# codes, more slots than a block's shared memory stages, and the last
# code fits an int16.
CODE_SPAN = 8192
QUAD_CODE = MAX_SLOTS
BOX_CODE = QUAD_CODE + CODE_SPAN
MEDIUM_CODE = BOX_CODE + CODE_SPAN


def encode_winner(fam, idx):
    """The int16 code of each winner (fam, idx (N,), geometry.FAM_*),
    as an int64 tensor: -1 on a miss."""
    from ..geometry import FAM_BOX, FAM_MEDIUM, FAM_NONE, FAM_QUAD
    fam, idx = fam.long(), idx.long()
    code = torch.where(fam == FAM_QUAD, QUAD_CODE + idx,
                       torch.where(fam == FAM_BOX, BOX_CODE + idx, idx))
    code = torch.where(fam == FAM_MEDIUM, MEDIUM_CODE + idx, code)
    return torch.where(fam == FAM_NONE, -1, code)


def decode_winner(code):
    """(fam, idx) of int16 winner codes (N,), both int64; a miss (-1)
    decodes to (FAM_NONE, -1), an unstored entry (-2) to (FAM_NONE,
    -2)."""
    from ..geometry import (FAM_BOX, FAM_MEDIUM, FAM_NONE, FAM_QUAD,
                            FAM_SPHERE)
    code = code.long()
    fam = torch.where(code >= BOX_CODE, FAM_BOX,
                      torch.where(code >= QUAD_CODE, FAM_QUAD, FAM_SPHERE))
    fam = torch.where(code >= MEDIUM_CODE, FAM_MEDIUM, fam)
    fam = torch.where(code < 0, FAM_NONE, fam)
    base = torch.where(fam == FAM_BOX, BOX_CODE,
                       torch.where(fam == FAM_QUAD, QUAD_CODE, 0))
    base = torch.where(fam == FAM_MEDIUM, MEDIUM_CODE, base)
    return fam, code - base


# The ROADMAP entry of an image texture on a constant medium: rrt_tpu
# packs a medium's albedo as a solid (its texture's color1) and sends
# such a scene to its XLA route, whose eager texture samples the image
# at uv 0; the port's eager route is the CPU's (the batch driver and the
# scan), and on a card such a scene raises before any launch.
IMAGES_ON_MEDIA = ("an image texture on a constant medium",
                   '"Not ported by decision": images on media')


def roadmap_ref(item: str) -> str:
    """Where ROADMAP.md places a scope gap's item: "ROADMAP Queue A
    #9.4" for a queued item ("#9.4"), else "ROADMAP" and the entry."""
    return (f"ROADMAP Queue A {item}" if item.startswith("#")
            else f"ROADMAP {item}")


def scope_gap(scene: SceneArrays, eager: bool = False):
    """None when the forward kernels cover the scene; otherwise (what is
    outside, its ROADMAP entry: a decision, which roadmap_ref places).
    eager: the scope of the eager shading on the CPU (the batch driver,
    the scan), which takes an image on a medium as rrt_tpu's eager code
    does. The train kernels' scope is narrower
    (megakernel_train.train_scope_gap), and chain_bwd's narrower still
    (megakernel_vjp.backward_scope_gap)."""
    if scene.has_images_on_media and not eager:
        return IMAGES_ON_MEDIA
    return None


def check_scope(scene: SceneArrays, eager: bool = False):
    """Raise NotImplementedError for a scene the tile kernel does not
    cover (scope_gap), naming its ROADMAP entry."""
    gap = scope_gap(scene, eager)
    if gap is not None:
        raise NotImplementedError(
            f"{gap[0]}: outside the rrt_tpu_torch tile kernel's scope "
            f"({roadmap_ref(gap[1])})")


@dataclasses.dataclass(frozen=True)
class SolidPacks:
    """The quad, box and medium packs (layouts in the module docstring)
    of a scene with quads, boxes, media or a diffuse_light, and their
    active slot counts: the kernels test slots [0, n_quads), [0, n_boxes)
    and [0, n_media) (the builder puts a family's valid slots first).
    med24 is None for a scene without media; tree the families'
    accel.SolidBvh, which the forward kernels walk past SOLID_CAP active
    slots of a family (required on a card there)."""

    quad24: torch.Tensor  # (24, Q)
    box24: torch.Tensor  # (24, B)
    n_quads: int
    n_boxes: int
    n_media: int = 0
    med24: torch.Tensor | None = None  # (D, 24)
    tree: accel.SolidBvh | None = None

    def to(self, device) -> "SolidPacks":
        return dataclasses.replace(
            self, quad24=self.quad24.to(device), box24=self.box24.to(device),
            med24=None if self.med24 is None else self.med24.to(device),
            tree=None if self.tree is None else self.tree.to(device))


@dataclasses.dataclass(frozen=True)
class TexPack:
    """The atlas (layout in the module docstring) of a scene with perlin
    or image textures, its grid (I, AH, AW), and which of the two the
    scene has (the plain versions' static flags)."""

    atlas: torch.Tensor  # (I * AH * AW, 4)
    shape: tuple  # (I, AH, AW)
    has_perlin: bool
    has_images: bool

    def to(self, device) -> "TexPack":
        return dataclasses.replace(self, atlas=self.atlas.to(device))

    def images(self):
        """The atlas as SceneArrays.images, (I, AH, AW, 3)."""
        return self.atlas[:, :3].reshape(*self.shape, 3)


def pack_atlas(images):
    """(I * AH * AW, 4) f32 atlas of images (I, AH, AW, 3), a
    differentiable function of them."""
    flat = images.reshape(-1, 3)
    return torch.cat([flat, torch.zeros_like(flat[:, :1])],
                     dim=1).contiguous()


def pack_textures(scene: SceneArrays, device=None):
    """The scene's TexPack (on `device`, when given); None for a scene
    without perlin or image textures, which the kernels' variants
    without textures render."""
    if not (scene.has_perlin or scene.has_images):
        return None
    tex = TexPack(pack_atlas(scene.images), tuple(scene.images.shape[:3]),
                  scene.has_perlin, scene.has_images)
    return tex if device is None else tex.to(device)


def pack_solids(scene: SceneArrays, device=None):
    """The scene's SolidPacks (on `device`, when given), differentiable
    functions of its tensors, with the families' accel.SolidBvh (built on
    the host from the packs, empty for families the kernels loop over;
    render builds it once a render); None for a scene of spheres alone
    without a light or a medium, which the kernels' sphere variants
    render."""
    if not (scene.has_quads or scene.has_boxes or scene.has_emissive
            or scene.has_media):
        return None
    quad24, box24 = pack_quads_full(scene), pack_boxes_full(scene)
    packs = SolidPacks(
        quad24, box24, scene.n_quads_active, scene.n_boxes_active,
        scene.n_media_active, pack_media(scene) if scene.has_media else None,
        accel.pack_solid_bvh(quad24, box24, scene.n_quads_active,
                             scene.n_boxes_active))
    return packs if device is None else packs.to(device)


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
    tex = scene.mat_tex[scene.sphere_mat.long()].long()
    f32 = torch.float32
    return torch.cat([
        base.T, r2[None], vel.T, scene.sphere_valid.to(f32)[None],
        _mat_rows(scene, scene.sphere_mat), radius[None],
        scene.tex_image[tex].to(f32)[None],
        torch.zeros((4, radius.shape[0]), dtype=f32, device=radius.device),
    ], dim=0).contiguous()


def _mat_rows(scene: SceneArrays, mat_ids):
    """(10, n) rows of each slot's resolved material: type, aux (a
    dielectric's ior, else the fuzz), color1 rgb, color2 rgb, texture
    type, texture scale (rrt_tpu's megakernel._mat_rows)."""
    mat = mat_ids.long()
    mtype = scene.mat_type[mat]
    aux = torch.where(mtype == MAT_DIELECTRIC, scene.mat_ior[mat],
                      scene.mat_fuzz[mat])
    tex = scene.mat_tex[mat].long()
    f32 = torch.float32
    return torch.cat([
        mtype.to(f32)[None], aux[None], scene.tex_color1[tex].T,
        scene.tex_color2[tex].T, scene.tex_type[tex].to(f32)[None],
        scene.tex_scale[tex][None]])


def pack_quads_full(scene: SceneArrays):
    """(24, Q) f32 quad pack (layout in the module docstring)."""
    n = scene.quad_q.shape[0]
    f32 = torch.float32
    tex = scene.mat_tex[scene.quad_mat.long()].long()
    return torch.cat([
        scene.quad_q.T, scene.quad_u.T, scene.quad_v.T,
        scene.quad_valid.to(f32)[None], _mat_rows(scene, scene.quad_mat),
        scene.tex_image[tex].to(f32)[None],
        torch.zeros((3, n), dtype=f32, device=scene.quad_q.device),
    ]).contiguous()


def quad_frame_pack(quad24):
    """rrt_tpu's (24, Q) quad pack of the port's quad pack (24, Q): the
    plane frame (geometry.quad_frames: 0-2 n, 3-5 g, 6-8 h, 9 d_plane,
    10 q.g, 11 q.h, 12 eps_n), then 13 valid, 14 mat_type, 15 aux, 16-18
    color1, 19-21 color2, 22 tex_type, 23 tex_scale: the rows
    megakernel_vjp.diff_step reads of a quad winner, differentiable in
    quad24."""
    from ..geometry import quad_frames
    fr = quad_frames(quad24[0:3], quad24[3:6], quad24[6:9])
    return torch.cat([fr.n, fr.g, fr.h, fr.d_plane[None], fr.q_g[None],
                      fr.q_h[None], fr.eps_n[None], quad24[9:20]])


def pack_boxes_full(scene: SceneArrays):
    """(24, B) f32 box pack, rrt_tpu's (layout in the module docstring):
    invalid slots pack zero half extents, which no ray's slab interval
    can enter."""
    n = scene.box_half.shape[0]
    f32 = torch.float32
    half = torch.where(scene.box_valid[:, None], scene.box_half, 0.0)
    return torch.cat([
        scene.box_center.T, half.T, scene.box_cos[None], scene.box_sin[None],
        scene.box_valid.to(f32)[None], _mat_rows(scene, scene.box_mat),
        torch.zeros((5, n), dtype=f32, device=scene.box_half.device),
    ]).contiguous()


def pack_media(scene: SceneArrays):
    """(D, 24) f32 medium pack, rrt_tpu's (layout in the module
    docstring), a differentiable function of the scene's tensors. A
    medium's material is isotropic by construction (SceneBuilder's
    medium_* make it), so its albedo, its texture's color1, is packed and
    no material type."""
    d = scene.med_radius.shape[0]
    f32 = torch.float32
    alb = scene.tex_color1[scene.mat_tex[scene.med_mat.long()].long()]
    return torch.cat([
        scene.med_btype.to(f32)[:, None], scene.med_center,
        scene.med_radius[:, None], scene.med_half,
        scene.med_rot.reshape(d, 9), scene.med_neg_inv_density[:, None],
        scene.med_valid.to(f32)[:, None], alb,
        torch.zeros((d, 2), dtype=f32, device=alb.device)], dim=1).contiguous()


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


def check_window(height: int, row_lo: int = 0, row_hi: int | None = None):
    """The band of rows [row_lo, row_hi) a tile launch traces (row_hi
    None: the image's last row), checked: 0 <= row_lo < row_hi <= height.
    Returns (row_lo, row_hi)."""
    row_hi = height if row_hi is None else row_hi
    if not 0 <= row_lo < row_hi <= height:
        raise ValueError(f"row window [{row_lo}, {row_hi}) is outside the "
                         f"image's rows [0, {height})")
    return int(row_lo), int(row_hi)


def _check_inputs(sph24, cam24, bg8, width, height, spp, max_depth,
                  rr_depth=0):
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
    if width < 1 or height < 1 or spp < 1 or max_depth < 0 or rr_depth < 0:
        raise ValueError(f"bad render size {width}x{height} spp={spp} "
                         f"max_depth={max_depth} rr_depth={rr_depth}")


def _check_bvh(bvh, sph24, what: str):
    """The BVH pack a walking kernel takes on the card: accel.pack_bvh's
    of this sphere pack, on its device."""
    if bvh is None:
        raise ValueError(f"{what} on {sph24.device} needs the sphere pack's "
                         f"BVH (accel.pack_bvh)")
    if bvh.n_slots != sph24.shape[1] or bvh.nodes.device != sph24.device \
            or bvh.rows.device != sph24.device:
        raise ValueError(f"the BVH is of {bvh.n_slots} slots on "
                         f"{bvh.nodes.device}, sph24 ({sph24.shape[1]}) on "
                         f"{sph24.device}")
    if bvh.depth > accel.BVH_STACK:
        raise ValueError(f"the BVH is {bvh.depth} levels deep, past the "
                         f"kernels' stack of {accel.BVH_STACK}")
    return (bvh.nodes.data_ptr(), bvh.rows.data_ptr(), bvh.n_nodes,
            bvh.n_rows, bvh.n_always)


# How a kernel takes the solid families (_check_solids' `scope`): "walk"
# the forward kernels, train_fwd and chain_bwd, which walk a family's
# tree past SOLID_CAP active slots; "loop" train_bwd, which loops over
# any number.
SOLID_SCOPES = ("walk", "loop")


def _check_solids(solids, device, scope: str):
    """The C argument of the solid families (a pointer to an
    _build.SolidArgs), checked: the quad and box packs float32 (24, n),
    contiguous, on `device`, their active counts within their widths; the
    medium pack, with n_media > 0, float32 (D, 24), contiguous, on
    `device`, D >= n_media; None (a null pointer: the sphere variants)
    for None. scope (SOLID_SCOPES): "walk" fills the families' trees on
    a CUDA device (_check_tree)."""
    if scope not in SOLID_SCOPES:
        raise ValueError(f"scope {scope!r} is none of {SOLID_SCOPES}")
    if solids is None:
        return None
    for name, t, n in (("quad24", solids.quad24, solids.n_quads),
                       ("box24", solids.box24, solids.n_boxes)):
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
                or t.dim() != 2 or t.shape[0] != 24 or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name} must be a contiguous (24, n) float32 "
                             f"tensor on {device}")
        if not 0 <= n <= t.shape[1]:
            raise ValueError(f"{n} active slots of {name}'s {t.shape[1]}")
    med = solids.med24
    if solids.n_media:
        if (not isinstance(med, torch.Tensor) or med.dtype != torch.float32
                or med.dim() != 2 or med.shape[1] != 24
                or not med.is_contiguous() or med.device != device
                or not 0 < solids.n_media <= med.shape[0]):
            raise ValueError(f"med24 must be a contiguous (D, 24) float32 "
                             f"tensor on {device} with D >= n_media "
                             f"({solids.n_media})")
    args = _build.SolidArgs(
        solids.quad24.data_ptr(), solids.quad24.shape[1], solids.n_quads,
        solids.box24.data_ptr(), solids.box24.shape[1], solids.n_boxes,
        med.data_ptr() if solids.n_media else None, solids.n_media)
    if scope == "walk" and device.type == "cuda":
        _check_tree(solids, device, args)
    return ctypes.byref(args)


def check_codes(solids):
    """Raise NotImplementedError, before a launch, for a solid family
    past the CODE_SPAN slots its winner codes hold (the train kernels'
    and chain_bwd's int16 residual and records)."""
    if solids is None:
        return
    for what, n in (("quads", solids.n_quads), ("boxes", solids.n_boxes),
                    ("media", solids.n_media)):
        if n > CODE_SPAN:
            raise NotImplementedError(
                f"{n} active {what}: the winner codes hold {CODE_SPAN} a "
                f"family (ROADMAP {FORWARD_SMEM_ITEM})")


def _check_tree(solids, device, args):
    """Fill the trees' fields of the SolidArgs `args` from solids.tree
    (accel.SolidBvh of these packs' active slots, on `device`); without a
    tree the walking kernels loop, which they do up to SOLID_CAP slots of
    a family."""
    tree = solids.tree
    if tree is None:
        if max(solids.n_quads, solids.n_boxes) > SOLID_CAP:
            raise ValueError(
                f"{max(solids.n_quads, solids.n_boxes)} active quads or "
                f"boxes on {device} need the families' trees (pack_solids)")
        return
    if (tree.quad.n_slots, tree.box.n_slots) != (solids.n_quads,
                                                 solids.n_boxes):
        raise ValueError(f"the solid trees are of {tree.quad.n_slots} quads "
                         f"and {tree.box.n_slots} boxes, the packs' active "
                         f"{solids.n_quads} and {solids.n_boxes}")
    tensors = (tree.quad.nodes, tree.quad.rows, tree.box.nodes,
               tree.box.rows)
    if any(t.device != device for t in tensors):
        raise ValueError(f"the solid trees must be on {device}")
    for f, fam in (("quad", tree.quad), ("box", tree.box)):
        if fam.depth > accel.BVH_STACK:
            raise ValueError(f"the {f} tree is {fam.depth} levels deep, past "
                             f"the kernels' stack of {accel.BVH_STACK}")
        setattr(args, f"{f}_nodes", fam.nodes.data_ptr())
        setattr(args, f"{f}_rows", fam.rows.data_ptr())
        setattr(args, f"{f}_n_nodes", fam.n_nodes)
        setattr(args, f"{f}_n_rows", fam.n_rows)
        setattr(args, f"{f}_n_always", fam.n_always)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def forward_smem_bytes(bvh, solids, moving: bool) -> int:
    """A forward kernel's, or chain_bwd's, dynamic shared memory
    (csrc/bounce.cuh forward_smem): the spheres' BVH
    (accel.BvhPack.smem_bytes), then with solids their rows (three float4
    and an int a quad, two float4 a box: solid_bytes) and their trees
    (accel.SolidBvh.smem_bytes)."""
    smem = bvh.smem_bytes(moving)
    if solids is None:
        return smem
    rows = 16 * (3 * solids.n_quads + 2 * solids.n_boxes) + 4 * solids.n_quads
    trees = 0 if solids.tree is None else solids.tree.smem_bytes()
    return _align16(smem) + _align16(rows) + trees


def _check_forward_smem(bvh, solids, moving: bool, what: str):
    """Raise NotImplementedError, before a launch, when what a forward
    kernel, or chain_bwd, stages (forward_smem_bytes) exceeds the shared
    memory a block may opt into (accel.BVH_SMEM)."""
    need = forward_smem_bytes(bvh, solids, moving)
    if need > accel.BVH_SMEM:
        raise NotImplementedError(
            f"{what} stages {need} bytes of spheres, solid rows and solid "
            f"trees, past the {accel.BVH_SMEM} a block may opt into "
            f"({solids.n_quads} quads, {solids.n_boxes} boxes: ROADMAP "
            f"{FORWARD_SMEM_ITEM})")


# The kernels forward_blocks reports, as the C entry points number them.
_BLOCKS_KERNELS = ("tile_render", "bounce_steps", "intersect_only")


def forward_blocks(kernel: str, sph24, bvh, *, moving: bool, solids=None,
                   tex=None):
    """The blocks an SM of the instantiation a forward kernel ("tile_render",
    "bounce_steps" or "intersect_only") launches for these packs on their
    CUDA device, at the dynamic shared memory the launch takes (the C
    entry points' forward_smem): {"blocks", "smem_bytes"}."""
    device = sph24.device
    _, _, n_nodes, n_rows, _ = _check_bvh(bvh, sph24, kernel)
    solid_arg = _check_solids(solids, device, "walk")
    _check_forward_smem(bvh, solids, moving, kernel)
    lib = _build.load()
    blocks, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    out = (ctypes.byref(blocks), ctypes.byref(smem))
    with torch.cuda.device(device):
        if kernel == "tile_render":
            err = lib.rrt_tile_render_blocks(n_nodes, n_rows, int(moving),
                                             solid_arg, int(tex is not None),
                                             *out)
        else:
            err = lib.rrt_queue_blocks(
                _BLOCKS_KERNELS.index(kernel) - 1, n_nodes, n_rows,
                int(moving), solid_arg, int(tex is not None), *out)
    _launch_error(lib, err, f"{kernel}'s occupancy query")
    return {"blocks": blocks.value, "smem_bytes": smem.value}


def _check_tex(tex, device, d_atlas=None):
    """The C argument of the textures (a pointer to an _build.TexArgs),
    checked: the atlas a contiguous (I * AH * AW, 4) float32 tensor on
    `device`, and d_atlas (the backward's cotangent, or None) its like;
    None (a null pointer: the variants without textures) for None."""
    if tex is None:
        return None
    n_img, ah, aw = tex.shape
    for name, t in (("atlas", tex.atlas), ("d_atlas", d_atlas)):
        if t is None and name == "d_atlas":
            continue
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
                or tuple(t.shape) != (n_img * ah * aw, 4)
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{name} must be a contiguous "
                             f"({n_img * ah * aw}, 4) float32 tensor on "
                             f"{device}")
    return ctypes.byref(_build.TexArgs(
        tex.atlas.data_ptr(), None if d_atlas is None else d_atlas.data_ptr(),
        n_img, ah, aw))


def render_tiles(sph24, cam24, bg8, *, seed_words, sample_lo: int,
                 width: int, height: int, spp: int, max_depth: int,
                 t_min: float, moving: bool, bvh=None, solids=None,
                 tex=None, rr_depth: int = 0, row_lo: int = 0,
                 row_hi: int | None = None):
    """Render samples [sample_lo, sample_lo + spp) of every pixel of
    the rows [row_lo, row_hi) (default all; check_window).

    sph24 (24,S), cam24 (24,) and bg8 (8,) are the packs, all on one
    device; seed_words: the (s0, s1) u32 key words of the seed; moving:
    the moving-sphere variant (the scene's has_moving); bvh: the sphere
    pack's accel.BvhPack on the same device, its shutter the camera's
    (cam24 rows 19-20), which the kernel walks: required on a CUDA
    device, not read on the CPU; solids: the scene's SolidPacks (quads,
    boxes, a light: the kernel's solid-family variant) or None; tex:
    the scene's TexPack (perlin or image textures: the texture variant)
    or None; rr_depth: Russian roulette's first bounce (0: off; the
    module docstring). Returns (radiance sums (P,3) f32 in scan-line
    order, traced-ray counts (P,) int32), P = width * (row_hi - row_lo),
    on the packs' device. A pixel's keys are those of its id in the
    whole image, so a band is the full launch's rows bit for bit.

    CUDA tensors launch the kernel (and count the launch in
    `render_tiles.launches`); CPU tensors run render_tiles_reference,
    whose linear scan gives the walk's winners."""
    _check_inputs(sph24, cam24, bg8, width, height, spp, max_depth,
                  rr_depth)
    row_lo, row_hi = check_window(height, row_lo, row_hi)
    kw = dict(seed_words=seed_words, sample_lo=sample_lo, width=width,
              height=height, spp=spp, max_depth=max_depth, t_min=t_min,
              moving=moving, solids=solids, tex=tex, rr_depth=rr_depth,
              row_lo=row_lo, row_hi=row_hi)
    device = sph24.device
    solid_arg = _check_solids(solids, device, "walk")
    tex_arg = _check_tex(tex, device)
    if device.type == "cpu":
        return render_tiles_reference(sph24, cam24, bg8, **kw)
    if device.type != "cuda":
        raise ValueError(f"render_tiles runs on cuda or cpu, not {device}")
    n_slots = sph24.shape[1]
    if n_slots > MAX_SLOTS:
        raise ValueError(f"{n_slots} sphere slots exceed the kernel's "
                         f"{MAX_SLOTS}")
    tree = _check_bvh(bvh, sph24, "render_tiles")
    _check_forward_smem(bvh, solids, moving, "render_tiles")
    lib = _build.load()
    n_pix = width * (row_hi - row_lo)
    rad = torch.empty((n_pix, 3), dtype=torch.float32, device=device)
    traced = torch.empty((n_pix,), dtype=torch.int32, device=device)
    s0, s1 = rng._seed_words(tuple(seed_words))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rrt_tile_render(
            sph24.data_ptr(), n_slots, cam24.data_ptr(), bg8.data_ptr(),
            *tree, solid_arg, tex_arg, s0, s1, sample_lo & rng.MASK32,
            width, row_lo, row_hi, spp, max_depth, rr_depth, t_min,
            int(moving), rad.data_ptr(), traced.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("tile_render launch failed: "
                           + lib.rrt_error_string(err).decode())
    render_tiles.launches += 1
    return rad, traced


render_tiles.launches = 0


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _scene_from_packs(sph24, bg8, moving: bool, solids=None,
                      tex=None) -> SceneArrays:
    """The scene the packs describe, with one material and one texture
    per slot (the packs hold each slot's resolved material: the
    spheres', then the active quads', then the active boxes'). moving:
    the spheres move with the velocity rows 4-6 from base rows 0-2
    (time0 0, time1 1), so make_hit's center is base + time * vel;
    otherwise the scene is static. solids: SolidPacks, whose active
    slots become the quad, box and medium families (and whose presence
    turns on the lights' emission, as in the kernels' solid-family
    variant), a medium's material isotropic with its packed albedo. tex:
    the TexPack, whose atlas becomes the scene's images and whose flags
    its has_perlin and has_images (a slot's image index is its pack's
    row 19, a quad's row 20). Without bg8 the background is the default
    sky (intersection only)."""
    dev = sph24.device
    n = sph24.shape[1]
    if bg8 is None:
        bg8 = torch.zeros((8,), device=dev)
    mats = [sph24[8:18]]
    images = [sph24[19]]
    fam = {name: torch.zeros((0,), device=dev) for name in tensor_fields()
           if name.startswith(("quad_", "box_", "med_"))}
    counts = dict(n_quads_active=0, n_boxes_active=0)
    if solids is not None:
        nq, nb = solids.n_quads, solids.n_boxes
        quad, box = solids.quad24[:, :nq], solids.box24[:, :nb]
        ids = torch.arange(nq + nb, dtype=torch.int32, device=dev) + n
        fam.update(quad_q=quad[0:3].T, quad_u=quad[3:6].T,
                   quad_v=quad[6:9].T, quad_mat=ids[:nq],
                   quad_valid=quad[9] > 0.5, box_center=box[0:3].T,
                   box_half=box[3:6].T, box_cos=box[6], box_sin=box[7],
                   box_mat=ids[nq:], box_valid=box[8] > 0.5)
        mats += [quad[10:20], box[9:19]]
        images += [quad[20], torch.zeros((nb,), device=dev)]
        counts = dict(n_quads_active=nq, n_boxes_active=nb, has_quads=nq > 0,
                      has_boxes=nb > 0, has_emissive=True)
        nm = solids.n_media
        if nm:
            med = solids.med24[:nm]
            fam.update(med_btype=med[:, 0].to(torch.int32),
                       med_center=med[:, 1:4], med_radius=med[:, 4],
                       med_half=med[:, 5:8],
                       med_rot=med[:, 8:17].reshape(nm, 3, 3),
                       med_neg_inv_density=med[:, 17],
                       med_mat=torch.arange(nm, dtype=torch.int32,
                                            device=dev) + n + nq + nb,
                       med_valid=med[:, 18] > 0.5)
            iso = torch.zeros((10, nm), device=dev)
            iso[0] = MAT_ISOTROPIC
            iso[2:5] = med[:, 19:22].T
            mats.append(iso)
            images.append(torch.zeros((nm,), device=dev))
            counts.update(has_media=True, n_media_active=nm)
    mat = torch.cat(mats, dim=1)
    slots = torch.arange(mat.shape[1], dtype=torch.int32, device=dev)
    mtype = mat[0].to(torch.int32)
    is_die = mtype == MAT_DIELECTRIC
    return SceneArrays(
        sphere_c0=sph24[0:3].T,
        sphere_dc=(sph24[4:7].T if moving
                   else torch.zeros((n, 3), device=dev)),
        sphere_t0=torch.zeros((n,), device=dev),
        sphere_inv_dt=torch.ones((n,), device=dev),
        sphere_radius=sph24[18], sphere_mat=slots[:n],
        sphere_valid=sph24[7] > 0.5,
        mat_type=mtype, mat_tex=slots,
        mat_fuzz=torch.where(is_die, 0.0, mat[1]),
        mat_ior=torch.where(is_die, mat[1], 1.0),
        tex_type=mat[8].to(torch.int32), tex_color1=mat[2:5].T,
        tex_color2=mat[5:8].T, tex_scale=mat[9],
        tex_image=torch.cat(images).to(torch.int32),
        images=(torch.zeros((1, 1, 1, 3), device=dev) if tex is None
                else tex.images()),
        has_perlin=tex is not None and tex.has_perlin,
        has_images=tex is not None and tex.has_images,
        bg_mode=bg8[6].to(torch.int32), bg_bottom=bg8[0:3],
        bg_top=bg8[3:6], n_spheres_active=n, has_moving=moving, **counts,
        **fam)


# Rays a chunk of the plain tile loop. The loop is bound by the host's
# dispatch of a bounce's eager ops, so fewer, larger chunks are faster;
# the (N, S) intersection broadcast of a chunk at 512 slots takes about
# 1 GB a tensor on the device.
PLAIN_CHUNK = 1 << 19


def render_tiles_reference(sph24, cam24, bg8, *, seed_words,
                           sample_lo: int, width: int, height: int,
                           spp: int, max_depth: int, t_min: float,
                           moving: bool, solids=None, tex=None,
                           rr_depth: int = 0, row_lo: int = 0,
                           row_hi: int | None = None,
                           chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of `render_tiles`, same inputs and outputs.

    A wavefront loop over (pixel, sample) rays, `chunk` rays at a time in
    sample-major order, built from the port's camera, geometry,
    materials and textures through render._bounce. Rays that die are
    dropped from the batch after each bounce. A chunk holds at most one
    sample of each pixel, so radiance is summed into each pixel in the
    kernel's order: sample by sample, bounce by bounce. Differentiable
    by plain autograd (slowly: every bounce keeps its (N,S) broadcast).
    Its families' exact ties go as in the kernel (quad, box, sphere), and
    Russian roulette is render._apply_rr's."""
    rad, traced, _, _ = trace_paths_reference(
        sph24, cam24, bg8, seed_words=seed_words, sample_lo=sample_lo,
        width=width, height=height, spp=spp, max_depth=max_depth,
        t_min=t_min, moving=moving, solids=solids, tex=tex,
        rr_depth=rr_depth, row_lo=row_lo, row_hi=row_hi, chunk=chunk)
    return rad, traced


def trace_paths_reference(sph24, cam24, bg8, *, seed_words, sample_lo: int,
                          width: int, height: int, spp: int,
                          max_depth: int, t_min: float, moving: bool,
                          solids=None, tex=None, win_cap: int = 0,
                          rr_depth: int = 0, row_lo: int = 0,
                          row_hi: int | None = None,
                          chunk: int = PLAIN_CHUNK):
    """render_tiles_reference's loop over the rows [row_lo, row_hi)
    (check_window; P their pixels, each keyed by its id in the whole
    image), also returning each path's bounce count and the first
    win_cap segments' winners of each pixel: (rad
    (P,3), traced (P,) i32, lengths (spp, P) uint8, winners (win_cap, P)
    int16), where lengths[s, p] is the number of bounces sample s of
    pixel p traced, and winners[j, p] the slot that pixel p's j-th
    segment hit (-1 on a miss, -2 past its segments), in the order the
    pixel traces them: sample by sample, bounce by bounce; a winner is
    its encode_winner code (a quad's or box's slot offset by QUAD_CODE or
    BOX_CODE)."""
    from ..render import _apply_rr, _bounce  # render imports this module

    dev = sph24.device
    scene = _scene_from_packs(sph24, bg8, moving, solids, tex)
    basis = tuple(cam24[3 * i:3 * i + 3] for i in range(6))
    row_lo, row_hi = check_window(height, row_lo, row_hi)
    n_pix = width * (row_hi - row_lo)
    n_rays = n_pix * spp
    chunk = min(chunk, n_pix)
    rad = torch.zeros((3, n_pix), dtype=torch.float32, device=dev)
    traced = torch.zeros((n_pix,), dtype=torch.int32, device=dev)
    lengths = torch.zeros((n_rays,), dtype=torch.uint8, device=dev)
    winners = torch.full((win_cap, n_pix), -2, dtype=torch.int16,
                         device=dev)
    for lo in range(0, n_rays, chunk):
        ray = torch.arange(lo, min(lo + chunk, n_rays), device=dev)
        pix = ray % n_pix  # the band's; keyed by the image's id
        gid = pix + row_lo * width
        keys = rng.sample_keys(tuple(seed_words), gid,
                               sample_lo + ray // n_pix)
        o, d, tm = thin_lens_rays(basis, cam24[18], cam24[19], cam24[20],
                                  gid % width, gid // width, width, height,
                                  keys)
        thr = torch.ones_like(o)
        for bounce in range(max_depth + 1):
            alive = torch.ones_like(pix, dtype=torch.bool)
            b = _bounce(scene, o, d, tm, keys, bounce, alive, t_min,
                        max_depth)
            if win_cap:
                # A chunk holds at most one sample of a pixel, and its
                # earlier samples are done: traced[pix] is the segment's j.
                j = traced[pix].long()
                stored = j < win_cap
                code = torch.where(b.miss_mask, -1,
                                   encode_winner(b.fam, b.win))
                winners[j[stored], pix[stored]] = code[stored].to(
                    torch.int16)
            rad[:, pix] += thr * b.contribution
            traced[pix] += 1
            lengths[ray] += 1
            thr, survives = _apply_rr(keys, bounce, thr,
                                      b.scatter.attenuation, b.survives,
                                      rr_depth)
            o, d = b.new_o, b.new_d
            keep = survives.nonzero()[:, 0]
            if keep.numel() == 0:
                break
            pix, ray, keys, o, d, tm, thr = (
                pix[keep], ray[keep], keys[:, keep], o[:, keep], d[:, keep],
                tm[keep], thr[:, keep])
    return (rad.T.contiguous(), traced, lengths.reshape(spp, n_pix),
            winners)


# ---------------------------------------------------------------------------
# The queue state and the bounce-steps kernel
# ---------------------------------------------------------------------------

# Rows of the (16, Q) f32 queue state, in rrt_tpu's order: o xyz, d xyz,
# time, throughput rgb, pending radiance rgb, bounce, alive, traced.
STATE_ROWS = 16
ROW_TIME, ROW_BOUNCE, ROW_ALIVE, ROW_TRACED = 6, 13, 14, 15


def pack_state(o, d, time, thr, pend, bounce, alive, traced):
    """o, d, thr, pend (3,Q) and time, bounce, alive, traced (Q,) -> the
    (16, Q) f32 queue state (rrt_tpu/ops/megakernel.py pack_state)."""
    f32 = torch.float32
    return torch.cat([
        o, d, time[None], thr, pend, bounce.to(f32)[None],
        alive.to(f32)[None], traced.to(f32)[None]]).to(f32).contiguous()


def unpack_state(st):
    """(o (3,Q), d (3,Q), time (Q,), thr (3,Q), pend (3,Q), bounce (Q,)
    int32, alive (Q,) bool, traced (Q,) f32) of a (16, Q) state."""
    return (st[0:3], st[3:6], st[ROW_TIME], st[7:10], st[10:13],
            st[ROW_BOUNCE].to(torch.int32), st[ROW_ALIVE] > 0.5,
            st[ROW_TRACED])


def _check_lanes(name, t, rows, dtype, device):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise TypeError(f"{name} must be a {dtype} tensor")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name} must be ({rows}, Q), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, sph24 on {device}")


def _check_spheres(sph24, bg8=None):
    _check_lanes("sph24", sph24, 24, torch.float32, sph24.device)
    if bg8 is not None:
        if (not isinstance(bg8, torch.Tensor) or bg8.dtype != torch.float32
                or tuple(bg8.shape) != (8,) or bg8.device != sph24.device):
            raise ValueError("bg8 must be an (8,) float32 tensor on sph24's "
                             "device")
    device = sph24.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda or cpu, not {device}")
    if device.type == "cuda" and sph24.shape[1] > MAX_SLOTS:
        raise ValueError(f"{sph24.shape[1]} sphere slots exceed the "
                         f"kernels' {MAX_SLOTS}")
    return device


def _launch_error(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.rrt_error_string(err).decode())


def bounce_steps(state, keys, sph24, bg8, *, k_steps: int, max_depth: int,
                 t_min: float, moving: bool, bvh=None, solids=None,
                 tex=None, rr_depth: int = 0):
    """Run k_steps bounce steps on every live lane of a queue state.

    state: (16, Q) f32 (pack_state's rows), updated IN PLACE and
    returned: each lane is read and written where it lies, which saves a
    (16, Q) copy a launch. keys: (2, Q) int32 holding each lane's u32
    sample-key words (rng.u32_bits). sph24 (24, S), bg8 (8,): the packs.
    moving: the moving-sphere variant, which reads each lane's time (row
    6). bvh: the sphere pack's accel.BvhPack on its device, its shutter
    covering the lanes' times, which the kernel walks: required on a
    CUDA device, not read on the CPU. solids, tex, rr_depth: as
    render_tiles'.

    Per live lane and step, as rrt_tpu's _one_bounce: traced += 1; a
    miss adds throughput x background to the pending radiance and kills
    the lane, as does a hit on a diffuse_light, with throughput x its
    color; a scatter below max_depth multiplies the throughput by the
    albedo (a dielectric's by 1), moves o and d, and adds 1 to bounce;
    an absorption, or a hit at max_depth, kills the lane, and from the
    lane's bounce row rr_depth on (rr_depth > 0) so does a lost Russian
    roulette coin, a won one weighting the throughput by 1 / p. A dead
    lane (alive row 0) passes through unchanged.

    CUDA tensors launch the kernel (counted in `bounce_steps.launches`);
    CPU tensors run bounce_steps_reference, whose linear scan gives the
    walk's winners."""
    device = _check_spheres(sph24, bg8)
    _check_lanes("state", state, STATE_ROWS, torch.float32, device)
    _check_lanes("keys", keys, 2, torch.int32, device)
    q = state.shape[1]
    if keys.shape[1] != q:
        raise ValueError(f"keys has {keys.shape[1]} lanes, state {q}")
    if k_steps < 1 or max_depth < 0 or rr_depth < 0:
        raise ValueError(f"bad k_steps={k_steps} max_depth={max_depth} "
                         f"rr_depth={rr_depth}")
    kw = dict(k_steps=k_steps, max_depth=max_depth, t_min=t_min,
              moving=moving, solids=solids, tex=tex, rr_depth=rr_depth)
    solid_arg = _check_solids(solids, device, "walk")
    tex_arg = _check_tex(tex, device)
    if device.type == "cpu":
        return bounce_steps_reference(state, keys, sph24, bg8, **kw)
    tree = _check_bvh(bvh, sph24, "bounce_steps")
    _check_forward_smem(bvh, solids, moving, "bounce_steps")
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.rrt_bounce_steps(
            state.data_ptr(), keys.data_ptr(), q, sph24.data_ptr(),
            sph24.shape[1], *tree, solid_arg, tex_arg, bg8.data_ptr(),
            k_steps, max_depth, rr_depth, t_min, int(moving),
            torch.cuda.current_stream(device).cuda_stream)
    _launch_error(lib, err, "bounce_steps")
    bounce_steps.launches += 1
    return state


bounce_steps.launches = 0


def bounce_steps_reference(state, keys, sph24, bg8, *, k_steps: int,
                           max_depth: int, t_min: float,
                           moving: bool, solids=None, tex=None,
                           rr_depth: int = 0):
    """Plain PyTorch version of `bounce_steps`, same inputs and outputs
    (the state is updated in place and returned): each step runs
    render._shade and render._apply_rr on the live lanes, with their own
    bounce counts, the families' exact ties as in the kernel (quad, box,
    sphere)."""
    from ..render import _apply_rr, _shade  # render imports this module

    scene = _scene_from_packs(sph24, bg8, moving, solids, tex)
    keys = rng.from_u32_bits(keys)
    for _ in range(k_steps):
        lanes = (state[ROW_ALIVE] > 0.5).nonzero()[:, 0]
        if lanes.numel() == 0:
            break
        st = state[:, lanes]
        o, d, time, thr, pend, bounce, alive, traced = unpack_state(st)
        lane_keys = keys[:, lanes]
        contrib, new_o, new_d, att, survives = _shade(
            scene, o, d, time, lane_keys, bounce, alive, t_min, max_depth)
        new_thr, survives = _apply_rr(lane_keys, bounce, thr, att, survives,
                                      rr_depth)
        if rr_depth:  # a lane the roulette kills keeps its ray, as in the kernel
            new_o = torch.where(survives, new_o, o)
            new_d = torch.where(survives, new_d, d)
        state[:, lanes] = pack_state(
            new_o, new_d, time, new_thr, pend + thr * contrib,
            bounce + survives.to(torch.int32), survives, traced + 1.0)
    return state


# ---------------------------------------------------------------------------
# The intersect-only kernel
# ---------------------------------------------------------------------------


def intersect_only(o, d, sph24, *, t_min: float, time=None, bvh=None,
                   solids=None, keys=None, bounce=None):
    """Closest hit of each ray. o, d: (3, Q) f32 rows x y z of the
    rays' origins and directions; time: None for a static scene, or for
    moving spheres (Q,) f32 the rays' times, a sphere's center then being
    base + time * vel: the kernel's moving variant (rrt_tpu's kernel
    takes (8, Q) rows of o, d, time and bounce; this one takes them
    apart). solids: as render_tiles' (the quads, boxes and media;
    rrt_tpu's kernel has no box family); with media, keys (2, Q) int32
    (each ray's u32 sample-key words, rng.u32_bits) and bounce (Q,) int32
    (its bounce counter) address each medium's STREAM_MEDIUM draw, as
    rrt_tpu's rays8 row 7 does. Returns (t (Q,) f32, INF on a miss; fam
    (Q,) int32, 0 for a sphere, 1 a quad, 2 a medium, 3 a box, -1 on a
    miss; idx (Q,) int32, the winning slot of its family, 0 on a miss):
    rrt_tpu's intersect_all contract, its exact ties between solid
    families going to the quad, then the box, as in its kernel, a medium
    winning with a strictly smaller t. bvh: the sphere pack's
    accel.BvhPack on the rays' device, its shutter covering the rays'
    times, which the kernel walks: required on a CUDA device, not read on
    the CPU.

    CUDA tensors launch the kernel (counted in `intersect_only.launches`);
    CPU tensors run intersect_only_reference, whose linear scan gives the
    walk's (t, fam, idx)."""
    device = _check_spheres(sph24)
    _check_lanes("o", o, 3, torch.float32, device)
    _check_lanes("d", d, 3, torch.float32, device)
    q = o.shape[1]
    if d.shape[1] != q:
        raise ValueError(f"d has {d.shape[1]} rays, o {q}")
    moving = time is not None
    if moving and (not isinstance(time, torch.Tensor)
                   or time.dtype != torch.float32
                   or tuple(time.shape) != (q,) or not time.is_contiguous()
                   or time.device != device):
        raise ValueError(f"time must be a contiguous ({q},) float32 tensor "
                         f"on {device}")
    solid_arg = _check_solids(solids, device, "walk")
    media = solids is not None and solids.n_media > 0
    if media:
        _check_lanes("keys", keys, 2, torch.int32, device)
        if (not isinstance(bounce, torch.Tensor) or bounce.dtype != torch.int32
                or tuple(bounce.shape) != (q,) or not bounce.is_contiguous()
                or bounce.device != device or keys.shape[1] != q):
            raise ValueError(f"a scene with media needs keys (2, {q}) and "
                             f"bounce ({q},) int32 on {device}")
    if device.type == "cpu":
        return intersect_only_reference(o, d, sph24, t_min=t_min, time=time,
                                        solids=solids, keys=keys,
                                        bounce=bounce)
    tree = _check_bvh(bvh, sph24, "intersect_only")
    _check_forward_smem(bvh, solids, moving, "intersect_only")
    t = torch.empty((q,), dtype=torch.float32, device=device)
    fam = torch.empty((q,), dtype=torch.int32, device=device)
    idx = torch.empty((q,), dtype=torch.int32, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.rrt_intersect(
            o.data_ptr(), d.data_ptr(), time.data_ptr() if moving else None,
            keys.data_ptr() if media else None,
            bounce.data_ptr() if media else None, q, sph24.data_ptr(),
            sph24.shape[1], *tree, solid_arg, t_min, int(moving),
            t.data_ptr(), fam.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _launch_error(lib, err, "intersect_only")
    intersect_only.launches += 1
    return t, fam, idx


intersect_only.launches = 0


def intersect_only_reference(o, d, sph24, *, t_min: float, time=None,
                             solids=None, keys=None, bounce=None):
    """Plain PyTorch version of `intersect_only`, same inputs and
    outputs: geometry.intersect_all on the packs' slots, with the
    kernel's order of exact ties (quad, box, sphere) and its media."""
    from ..geometry import INF, intersect_all

    scene = _scene_from_packs(sph24, None, time is not None, solids)
    u_med = None
    if scene.has_media:
        u_med = rng.medium_draws(rng.from_u32_bits(keys), bounce,
                                 scene.n_media_active)
    t, fam, idx = intersect_all(scene, o, d, time, t_min, INF, u_med)
    return t, fam.to(torch.int32), idx.to(torch.int32)
