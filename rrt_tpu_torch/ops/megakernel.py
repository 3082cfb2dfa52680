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
  `intersect_only` the closest sphere of each ray for the batch driver
                   (csrc/queue.cu), the counterpart of
                   `_intersect_kernel` for the sphere family; plain
                   `intersect_only_reference`.

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

A scene with moving spheres (`SceneArrays.has_moving`, the wrappers'
`moving=True`) runs each kernel's moving variant: a sphere's center at a
ray's time is base + time * vel (pack rows 0-2 and 4-6), and every ray
carries its time (the camera's shutter draw; state row 6). A static
scene runs the static variant, whose arithmetic reads no time.
"""

import torch

from .. import accel, rng
from . import _build
from ..camera import thin_lens_rays
from ..scene import MAT_DIELECTRIC, SceneArrays, tensor_fields

# Shared memory holds the intersection rows (0-3) of every slot, 16
# bytes a slot, inside the 48 KB a block gets without opting in.
MAX_SLOTS = 3072


def scope_gap(scene: SceneArrays, rr_depth: int = 0):
    """None when the tile kernels cover the scene and option; otherwise
    (what is outside, the ROADMAP Queue A item that ports it)."""
    outside = (
        (scene.has_quads, "quads", "#9.2"),
        (scene.has_emissive, "emissive materials", "#9.2"),
        (scene.has_boxes, "boxes", "#9.3"),
        (scene.has_media, "constant media", "#9.4"),
        (scene.has_perlin, "perlin textures", "#9.5"),
        (scene.has_images, "image textures", "#9.5"),
        (rr_depth > 0, "Russian roulette (rr_depth > 0)", "#9.6"),
    )
    return next(((what, item) for flag, what, item in outside if flag),
                None)


def check_scope(scene: SceneArrays, rr_depth: int = 0):
    """Raise NotImplementedError for a scene or option the tile kernel
    does not cover yet, naming the ROADMAP item that ports it."""
    gap = scope_gap(scene, rr_depth)
    if gap is not None:
        raise NotImplementedError(
            f"{gap[0]}: outside the rrt_tpu_torch tile kernel's scope "
            f"(ROADMAP Queue A {gap[1]})")


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


def render_tiles(sph24, cam24, bg8, *, seed_words, sample_lo: int,
                 width: int, height: int, spp: int, max_depth: int,
                 t_min: float, moving: bool, bvh=None):
    """Render samples [sample_lo, sample_lo + spp) of every pixel.

    sph24 (24,S), cam24 (24,) and bg8 (8,) are the packs, all on one
    device; seed_words: the (s0, s1) u32 key words of the seed; moving:
    the moving-sphere variant (the scene's has_moving); bvh: the sphere
    pack's accel.BvhPack on the same device, its shutter the camera's
    (cam24 rows 19-20), which the kernel walks: required on a CUDA
    device, not read on the CPU.
    Returns (radiance sums (P,3) f32 in scan-line order, traced-ray
    counts (P,) int32), P = width * height, on the packs' device.

    CUDA tensors launch the kernel (and count the launch in
    `render_tiles.launches`); CPU tensors run render_tiles_reference,
    whose linear scan gives the walk's winners."""
    _check_inputs(sph24, cam24, bg8, width, height, spp, max_depth)
    kw = dict(seed_words=seed_words, sample_lo=sample_lo, width=width,
              height=height, spp=spp, max_depth=max_depth, t_min=t_min,
              moving=moving)
    device = sph24.device
    if device.type == "cpu":
        return render_tiles_reference(sph24, cam24, bg8, **kw)
    if device.type != "cuda":
        raise ValueError(f"render_tiles runs on cuda or cpu, not {device}")
    n_slots = sph24.shape[1]
    if n_slots > MAX_SLOTS:
        raise ValueError(f"{n_slots} sphere slots exceed the kernel's "
                         f"{MAX_SLOTS}")
    tree = _check_bvh(bvh, sph24, "render_tiles")
    lib = _build.load()
    n_pix = width * height
    rad = torch.empty((n_pix, 3), dtype=torch.float32, device=device)
    traced = torch.empty((n_pix,), dtype=torch.int32, device=device)
    s0, s1 = rng._seed_words(tuple(seed_words))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rrt_tile_render(
            sph24.data_ptr(), n_slots, cam24.data_ptr(), bg8.data_ptr(),
            *tree, s0, s1, sample_lo & rng.MASK32, width, height, spp,
            max_depth, t_min, int(moving), rad.data_ptr(), traced.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError("tile_render launch failed: "
                           + lib.rrt_error_string(err).decode())
    render_tiles.launches += 1
    return rad, traced


render_tiles.launches = 0


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _scene_from_packs(sph24, bg8, moving: bool) -> SceneArrays:
    """The sphere scene the packs describe, with one material and one
    texture per slot (the pack holds each slot's resolved material).
    moving: the spheres move with the velocity rows 4-6 from base rows
    0-2 (time0 0, time1 1), so make_hit's center is base + time * vel;
    otherwise the scene is static. Without bg8 the background is the
    default sky (intersection only)."""
    dev = sph24.device
    n = sph24.shape[1]
    if bg8 is None:
        bg8 = torch.zeros((8,), device=dev)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    mtype = sph24[8].to(torch.int32)
    is_die = mtype == MAT_DIELECTRIC
    empty = {name: torch.zeros((0,), device=dev) for name in tensor_fields()
             if name.startswith(("quad_", "box_", "med_"))}
    return SceneArrays(
        sphere_c0=sph24[0:3].T,
        sphere_dc=(sph24[4:7].T if moving
                   else torch.zeros((n, 3), device=dev)),
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
        bg_top=bg8[3:6], n_spheres_active=n, has_moving=moving, **empty)


# Rays a chunk of the plain tile loop. The loop is bound by the host's
# dispatch of a bounce's eager ops, so fewer, larger chunks are faster;
# the (N, S) intersection broadcast of a chunk at 512 slots takes about
# 1 GB a tensor on the device.
PLAIN_CHUNK = 1 << 19


def render_tiles_reference(sph24, cam24, bg8, *, seed_words,
                           sample_lo: int, width: int, height: int,
                           spp: int, max_depth: int, t_min: float,
                           moving: bool, chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of `render_tiles`, same inputs and outputs.

    A wavefront loop over (pixel, sample) rays, `chunk` rays at a time in
    sample-major order, built from the port's camera, geometry,
    materials and textures through render._bounce. Rays that die are
    dropped from the batch after each bounce. A chunk holds at most one
    sample of each pixel, so radiance is summed into each pixel in the
    kernel's order: sample by sample, bounce by bounce. Differentiable
    by plain autograd (slowly: every bounce keeps its (N,S) broadcast)."""
    rad, traced, _, _ = trace_paths_reference(
        sph24, cam24, bg8, seed_words=seed_words, sample_lo=sample_lo,
        width=width, height=height, spp=spp, max_depth=max_depth,
        t_min=t_min, moving=moving, chunk=chunk)
    return rad, traced


def trace_paths_reference(sph24, cam24, bg8, *, seed_words, sample_lo: int,
                          width: int, height: int, spp: int,
                          max_depth: int, t_min: float, moving: bool,
                          win_cap: int = 0, chunk: int = PLAIN_CHUNK):
    """render_tiles_reference's loop, also returning each path's bounce
    count and the first win_cap segments' winners of each pixel: (rad
    (P,3), traced (P,) i32, lengths (spp, P) uint8, winners (win_cap, P)
    int16), where lengths[s, p] is the number of bounces sample s of
    pixel p traced, and winners[j, p] the slot that pixel p's j-th
    segment hit (-1 on a miss, -2 past its segments), in the order the
    pixel traces them: sample by sample, bounce by bounce."""
    from ..render import _bounce  # render imports this module

    dev = sph24.device
    scene = _scene_from_packs(sph24, bg8, moving)
    basis = tuple(cam24[3 * i:3 * i + 3] for i in range(6))
    n_pix = width * height
    n_rays = n_pix * spp
    chunk = min(chunk, n_pix)
    rad = torch.zeros((3, n_pix), dtype=torch.float32, device=dev)
    traced = torch.zeros((n_pix,), dtype=torch.int32, device=dev)
    lengths = torch.zeros((n_rays,), dtype=torch.uint8, device=dev)
    winners = torch.full((win_cap, n_pix), -2, dtype=torch.int16,
                         device=dev)
    for lo in range(0, n_rays, chunk):
        ray = torch.arange(lo, min(lo + chunk, n_rays), device=dev)
        pix = ray % n_pix
        keys = rng.sample_keys(tuple(seed_words), pix,
                               sample_lo + ray // n_pix)
        o, d, tm = thin_lens_rays(basis, cam24[18], cam24[19], cam24[20],
                                  pix % width, pix // width, width, height,
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
                winners[j[stored], pix[stored]] = torch.where(
                    b.miss_mask, -1, b.win)[stored].to(torch.int16)
            rad[:, pix] += thr * b.contribution
            traced[pix] += 1
            lengths[ray] += 1
            survives = b.survives
            thr = torch.where(survives, thr * b.scatter.attenuation, thr)
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
                 t_min: float, moving: bool, bvh=None):
    """Run k_steps bounce steps on every live lane of a queue state.

    state: (16, Q) f32 (pack_state's rows), updated IN PLACE and
    returned: each lane is read and written where it lies, which saves a
    (16, Q) copy a launch. keys: (2, Q) int32 holding each lane's u32
    sample-key words (rng.u32_bits). sph24 (24, S), bg8 (8,): the packs.
    moving: the moving-sphere variant, which reads each lane's time (row
    6). bvh: the sphere pack's accel.BvhPack on its device, its shutter
    covering the lanes' times, which the kernel walks: required on a
    CUDA device, not read on the CPU.

    Per live lane and step, as rrt_tpu's _one_bounce: traced += 1; a
    miss adds throughput x background to the pending radiance and kills
    the lane; a scatter below max_depth multiplies the throughput by the
    albedo (a dielectric's by 1), moves o and d, and adds 1 to bounce;
    an absorption, or a hit at max_depth, kills the lane. A dead lane
    (alive row 0) passes through unchanged.

    CUDA tensors launch the kernel (counted in `bounce_steps.launches`);
    CPU tensors run bounce_steps_reference, whose linear scan gives the
    walk's winners."""
    device = _check_spheres(sph24, bg8)
    _check_lanes("state", state, STATE_ROWS, torch.float32, device)
    _check_lanes("keys", keys, 2, torch.int32, device)
    q = state.shape[1]
    if keys.shape[1] != q:
        raise ValueError(f"keys has {keys.shape[1]} lanes, state {q}")
    if k_steps < 1 or max_depth < 0:
        raise ValueError(f"bad k_steps={k_steps} max_depth={max_depth}")
    kw = dict(k_steps=k_steps, max_depth=max_depth, t_min=t_min,
              moving=moving)
    if device.type == "cpu":
        return bounce_steps_reference(state, keys, sph24, bg8, **kw)
    tree = _check_bvh(bvh, sph24, "bounce_steps")
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.rrt_bounce_steps(
            state.data_ptr(), keys.data_ptr(), q, sph24.data_ptr(),
            sph24.shape[1], *tree, bg8.data_ptr(), k_steps, max_depth, t_min,
            int(moving), torch.cuda.current_stream(device).cuda_stream)
    _launch_error(lib, err, "bounce_steps")
    bounce_steps.launches += 1
    return state


bounce_steps.launches = 0


def bounce_steps_reference(state, keys, sph24, bg8, *, k_steps: int,
                           max_depth: int, t_min: float,
                           moving: bool):
    """Plain PyTorch version of `bounce_steps`, same inputs and outputs
    (the state is updated in place and returned): each step runs
    render._shade on the live lanes, with their own bounce counts."""
    from ..render import _shade  # render imports this module

    scene = _scene_from_packs(sph24, bg8, moving)
    keys = rng.from_u32_bits(keys)
    for _ in range(k_steps):
        lanes = (state[ROW_ALIVE] > 0.5).nonzero()[:, 0]
        if lanes.numel() == 0:
            break
        st = state[:, lanes]
        o, d, time, thr, pend, bounce, alive, traced = unpack_state(st)
        contrib, new_o, new_d, att, survives = _shade(
            scene, o, d, time, keys[:, lanes], bounce, alive, t_min,
            max_depth)
        state[:, lanes] = pack_state(
            new_o, new_d, time, torch.where(survives, thr * att, thr),
            pend + thr * contrib, bounce + survives.to(torch.int32),
            survives, traced + 1.0)
    return state


# ---------------------------------------------------------------------------
# The intersect-only kernel
# ---------------------------------------------------------------------------


def intersect_only(o, d, sph24, *, t_min: float, time=None, bvh=None):
    """Closest sphere of each ray. o, d: (3, Q) f32 rows x y z of the
    rays' origins and directions; time: None for a static scene, or for
    moving spheres (Q,) f32 the rays' times, a sphere's center then being
    base + time * vel: the kernel's moving variant (rrt_tpu's
    kernel takes (8, Q) rows that also hold each ray's bounce, for the
    media family, ROADMAP Queue A #9.4; the sphere family reads only o,
    d and time, so this kernel takes (3, Q) rows and a (Q,) time).
    Returns (t (Q,) f32, INF on a miss; fam (Q,) int32, 0 for a sphere,
    -1 on a miss; idx (Q,) int32, the winning slot, 0 on a miss):
    rrt_tpu's intersect_all contract. bvh: the sphere pack's
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
    if device.type == "cpu":
        return intersect_only_reference(o, d, sph24, t_min=t_min, time=time)
    tree = _check_bvh(bvh, sph24, "intersect_only")
    t = torch.empty((q,), dtype=torch.float32, device=device)
    fam = torch.empty((q,), dtype=torch.int32, device=device)
    idx = torch.empty((q,), dtype=torch.int32, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.rrt_intersect(
            o.data_ptr(), d.data_ptr(), time.data_ptr() if moving else None,
            q, sph24.data_ptr(), sph24.shape[1], *tree, t_min, int(moving),
            t.data_ptr(), fam.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _launch_error(lib, err, "intersect_only")
    intersect_only.launches += 1
    return t, fam, idx


intersect_only.launches = 0


def intersect_only_reference(o, d, sph24, *, t_min: float, time=None):
    """Plain PyTorch version of `intersect_only`, same inputs and
    outputs: geometry.intersect_spheres on the pack's slots."""
    from ..geometry import INF, intersect_spheres

    spheres = _scene_from_packs(sph24, None, time is not None)
    t, idx = intersect_spheres(spheres, o, d, time, t_min, INF)
    idx = idx.to(torch.int32)
    return t, torch.where(t < INF, 0, -1).to(torch.int32), idx
