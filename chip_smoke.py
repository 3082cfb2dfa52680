"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from rrt_tpu_torch/ops/csrc with nvcc and holds each
against its plain PyTorch version on the card. Then drives the main
paths on chap12 (RTIOW final, 484 spheres), each with the launch counts
set to 0 just before it and read just after:

  [4] the forward render, 1200x800, 32 spp, depth 50, through the CLI;
  [7] training, rrt_tpu_torch.diff.make_train_step at 1200x800, 8 spp,
      depth 50, three SGD steps (train_fwd + train_bwd);
  [8] the 500-spp north-star step, routed to the chunked trainer;
  [Q2] the queue driver through the CLI, 1200x800, 32 spp, depth 50, in
      four progressive passes of 8 spp (bounce_steps);
  [Q3] the batch driver through the CLI, 1200x800, 4 spp, depth 50
      (intersect_only).

[5] holds the train kernels against their plain versions, at two small
shapes and at [7]'s, and [6] checks their gradients with finite
differences at full size; [Q1] holds bounce_steps against its plain
version at [Q2]'s queue shape, and intersect_only against its at that
shape and at [Q3]'s batch shape, on camera rays and after 1-4 bounces. Prints the card's name and power
limit beside every time, one JSON line of the kernels (with each one's
least time on the card, `bound_ms`), and as its last line {"ok": true,
"device": {...}}. Any failure raises and exits non-zero; without a CUDA
device it exits 2 before printing any result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

MAIN = dict(scene="chap12", width=1200, height=800, spp=32, max_depth=50)
# tile_render's traced-ray count at MAIN, seed 0, on an H100: the kernel
# is deterministic, and moving its device code into bounce.cuh kept the
# count bit for bit.
MAIN_TRACED = 87_995_506
TRAIN = dict(width=1200, height=800, spp=8, max_depth=50)
NORTH_STAR_SPP = 500
MIX = (1.0, 0.7, 0.3)  # channel weights of the weighted-sum losses
REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
QUEUE_LANES = 131072  # RenderConfig.queue_size, the CLI's default
QUEUE_CHUNK = 8  # [Q2]'s --spp-chunk: four progressive passes
BATCH_SPP = 4
# The batch driver's rays a pass: RenderConfig's tile_pixels x
# samples_per_pass (the last tile of 1200x800 has 38,912).
BATCH_RAYS = 16384 * 4

# The least time an H100 SXM could take (NVIDIA's data sheet; at a
# 700 W power limit): FP32 outside the tensor
# cores, and HBM3.
FP32_PEAK = 67e12  # FLOP/s
HBM_RATE = 3.35e12  # bytes/s
# FP32 operations one ray-slot test needs (bounce.cuh closest_sphere),
# with what is constant per sphere (|c|^2 - r^2, 2c) hoisted out of it:
# d.c (5), o.2c (5), half_b (1), c_coef (2), disc (3) and the test of
# disc (1). The roots of the rare hit and the shading of the winner (a
# few hundred operations a bounce, under 3% of a 512-slot scan) are not
# counted: a lower bound.
FLOPS_PER_SLOT = 17
# FP32 operations of one bounce of train.cu's reverse sweep beyond the
# replay's scan: scatter_adjoint recomputes the winner's quadratic and
# shade() and runs the transpose (a count of its source, transcendentals
# as one operation each).
ADJOINT_FLOPS = 300


def bound(ops: float, n_bytes: float):
    """(bound_ms, bound_by): the larger of the operations over the FP32
    peak and the bytes (each input read once, each output written once)
    over the memory rate."""
    t_ops, t_bytes = ops / FP32_PEAK, n_bytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def check(ok: bool, what) -> None:
    """Fail the run (a check that `python -O` does not strip)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds of fn() over `repeats` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def compare(mk, tscenes, device, card, *, width, height, spp, max_depth,
            repeats=1):
    """Kernel vs plain version on the card, on the same packs. Returns
    (kernel out, plain out, kernel ms, plain ms)."""
    scene, cam = tscenes.chap12_scene(width, height)
    packs = (mk.pack_spheres_full(scene).to(device),
             mk.pack_camera(cam, width, height).to(device),
             mk.pack_bg(scene).to(device))
    kw = dict(seed_words=(0, 0), sample_lo=0, width=width, height=height,
              spp=spp, max_depth=max_depth, t_min=1e-3)
    out = mk.render_tiles(*packs, **kw)  # warm-up
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: mk.render_tiles(*packs, **kw), repeats)
    t0 = time.perf_counter()
    ref = mk.render_tiles_reference(*packs, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"  chap12 {width}x{height} {spp}spp d{max_depth}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms  [{card}]", flush=True)
    return out, ref, ms, plain_ms


def checker_scene(w, h):
    """The checker-texture, solid-background scene of
    tests/test_torch_cuda.py: the kernels' branches chap12 does not
    reach."""
    from rrt_tpu_torch.camera import Camera
    from rrt_tpu_torch.scene import SceneBuilder
    b = SceneBuilder()
    tex = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=10.0)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(tex))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), fuzz=0.3))
    b.sphere((-2.5, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.solid_background((0.3, 0.4, 0.5))
    cam = Camera.create(look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                        fov_deg=20.0, aspect=w / h, aperture=0.1,
                        focus_dist=10.0)
    return b.build(), cam


def wall_ms(fn):
    """(fn(), host milliseconds around it, ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def train_vs_plain(name, w, h, spp, depth, device, card, *,
                   min_pixels=0.99, min_paths=0.0, plain_chunk=1 << 16):
    """[5] The train kernels against tile_render and their plain
    versions on one configuration, by rrt_tpu_torch.gradcheck's rule:
    at least `min_pixels` of pixels and `min_paths` of paths agree
    sample by sample; the pixels that do not get loss weight 0."""
    from rrt_tpu_torch import diff, gradcheck, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_train as mkt
    build = checker_scene if name == "checker" else tscenes.SCENES[name]
    scene, cam = build(w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    packs = [p.detach() for p in render._packs(scene, cam, cfg, device)]
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3)
    rad, traced, lengths = mkt.render_tiles_train(*packs, **kw)
    ref_rad, ref_traced = mk.render_tiles(*packs, **kw)
    check(torch.equal(rad, ref_rad) and torch.equal(traced, ref_traced),
          "train_fwd differs from tile_render")
    check(torch.equal(lengths.sum(dim=0, dtype=torch.int32), traced),
          "lengths do not add up to the traced counts")
    fwd_ms = cuda_ms(lambda: mkt.render_tiles_train(*packs, **kw), 3)
    agreement = gradcheck.sample_agreement(packs, kw)
    frac = agreement.agree.float().mean().item()
    check(frac >= min_pixels and agreement.path_share >= min_paths,
          ("forward agreement", frac, agreement.path_share))
    weight = torch.sin(torch.arange(w * h, device=device) * 0.1) \
        * agreement.agree
    d_rad = (weight[:, None] * torch.tensor(MIX, device=device)).contiguous()
    k = mkt.tiles_adjoint(*packs, d_rad, lengths, **kw)
    bwd_ms = cuda_ms(lambda: mkt.tiles_adjoint(*packs, d_rad, lengths, **kw),
                     3)
    p, bwd_plain_ms = wall_ms(lambda: mkt.tiles_adjoint_reference(
        *packs, d_rad, agreement.lengths, chunk=plain_chunk, **kw))
    mism, p_mism = int(k[3]), int(p[3])
    check(mism == 0 and p_mism == 0, ("replay_mismatches", mism, p_mism))
    kp, kc = diff.field_grads(scene, cam, cfg, *k[:3], device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, *p[:3], device=device)
    faults, err = gradcheck.field_grad_faults(kp, kc, pp, pc)
    check(not faults, ("gradients", faults))
    fwd_err = ((rad - agreement.rad).abs().max() / spp).item()
    fwd_plain_ms = agreement.plain_seconds * 1e3
    print(f"  {name} {w}x{h} {spp}spp d{depth}: train_fwd == tile_render, "
          f"{frac:.4f} of pixels and {agreement.path_share:.5f} of paths "
          f"agree with the plain version, replay_mismatches {mism}, max "
          f"|grad delta| {err:.3e}; train_fwd {fwd_ms:.3f} ms (plain "
          f"{fwd_plain_ms:.1f} ms), train_bwd {bwd_ms:.3f} ms (plain "
          f"{bwd_plain_ms:.1f} ms)  [{card}]", flush=True)
    # Bounds: the forward's scan over the traced segments; the backward's
    # replay of the same scan plus its adjoint a bounce. Bytes: the packs
    # and the residual in, the outputs out.
    segments, n_slots, n_pix = int(traced.sum()), packs[0].shape[1], w * h
    scan = segments * n_slots * FLOPS_PER_SLOT
    pack_bytes = 4 * (24 * n_slots + 24 + 8)
    fwd_bound = bound(scan, pack_bytes + n_pix * (12 + 4 + spp))
    bwd_bound = bound(scan + segments * ADJOINT_FLOPS,
                      2 * pack_bytes + n_pix * (12 + spp) + 4)
    return dict(fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms, bwd_ms=bwd_ms,
                bwd_plain_ms=bwd_plain_ms, fwd_err=fwd_err, bwd_err=err,
                fwd_bound=fwd_bound, bwd_bound=bwd_bound)


def ground_texture(scene):
    return int(scene.mat_tex[scene.sphere_mat[0]])


def finite_differences(device, card):
    """[6] d loss / d (ground albedo red) and d loss / d bg_top[2] from
    train_bwd against central differences of the train_fwd forward at
    full size, loss = sum(MIX . radiance) in float64. Neither parameter
    changes a path decision, so eps = 1e-2 differences agree within 1e-2
    relative."""
    from rrt_tpu_torch import diff, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel_train as mkt
    scene, cam = tscenes.chap12_scene(TRAIN["width"], TRAIN["height"])
    cfg = render.RenderConfig(**TRAIN)
    kw = dict(seed_words=(0, 0), sample_lo=0, width=cfg.width,
              height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
              t_min=cfg.t_min)
    mix = torch.tensor(MIX, device=device)

    def forward(s):
        packs = [p.detach() for p in render._packs(s, cam, cfg, device)]
        return packs, mkt.render_tiles_train(*packs, **kw)

    packs, (rad, _, lengths) = forward(scene)
    d_sph, d_cam, d_bg, _ = mkt.tiles_adjoint(
        *packs, mix.expand_as(rad).contiguous(), lengths, **kw)
    gp, _ = diff.field_grads(scene, cam, cfg, d_sph, d_cam, d_bg,
                             device=device)
    eps = 1e-2
    for field, index in (("tex_color1", (ground_texture(scene), 0)),
                         ("bg_top", (2,))):
        def loss(delta):
            v = getattr(scene, field).clone()
            v[index] += delta
            r = forward(diff.combine(scene, {field: v}))[1][0]
            return (r.double() * mix.double()).sum().item()

        fd = (loss(eps) - loss(-eps)) / (2.0 * eps)
        auto = gp[field][index].item()
        rel = abs(auto - fd) / abs(fd)
        print(f"  d loss / d {field}{list(index)}: train_bwd {auto:.6e}, "
              f"central difference {fd:.6e}, {rel:.2e} apart", flush=True)
        check(auto != 0.0 and rel < 1e-2, (field, auto, fd))


def timed(fn, log):
    """fn with CUDA events recorded around each call into `log` (the
    calls' device time, read after a synchronize)."""
    def wrapper(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        log.append((start, end))
        return out
    return wrapper


def events_ms(log):
    return sum(s.elapsed_time(e) for s, e in log)


def device_breakdown(fn, card):
    """Run fn() under torch.profiler; print device time by kernel and
    the device's busy share of the host wall time."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, ms = wall_ms(fn)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"    {t:10.3f} ms  x{n:<4d} {key[:70]}")
    print(f"    device busy {busy:.2f} ms of {ms:.2f} ms wall "
          f"({busy / ms:.1%})  [{card}]", flush=True)
    return rows, busy, ms


def lane_state(scene, cam, w, h, n, device):
    """A queue state of n camera rays at sample 0 (16, n), its key bits
    and the packs, on the device; the pixels are spread evenly over the
    w x h image."""
    from rrt_tpu_torch import render, rng
    from rrt_tpu_torch.ops import megakernel as mk
    pix = torch.arange(n, device=device) * max(1, w * h // n) % (w * h)
    keys = rng.sample_keys(rng.key_words(0), pix, 0)
    o, d, tm = render.generate_rays(cam.to(device), pix % w, pix // w, w, h,
                                    keys)
    one = torch.ones((n,), device=device)
    zero = torch.zeros((n,), device=device)
    st = mk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                       one, zero)
    return (st, rng.u32_bits(keys), mk.pack_spheres_full(scene).to(device),
            mk.pack_bg(scene).to(device))


def intersect_vs_plain(what, o, d, sph):
    """intersect_only against its plain version on the rays (o, d): fam
    and idx equal on >= 99.9% of rays (the card's own spread: they agreed
    on every camera ray at full size), t within 1e-5 relative where they
    agree on a hit (both round every product), misses equal. Returns
    (share of rays agreeing, max |t delta| on agreeing hits, plain ms)."""
    from rrt_tpu_torch.ops import megakernel as mk
    t, fam, idx = mk.intersect_only(o, d, sph, t_min=1e-3)
    (rt, rfam, ridx), plain_ms = wall_ms(
        lambda: mk.intersect_only_reference(o, d, sph, t_min=1e-3))
    same = (fam == rfam) & (idx == ridx)
    hit = same & (fam == 0)
    miss = same & (fam == -1)
    t_rel = ((t - rt).abs() / rt)[hit].max().item() if hit.any() else 0.0
    frac = same.float().mean().item()
    print(f"  intersect_only {what}: fam and idx agree on {frac:.5f} of "
          f"{o.shape[1]} rays, {int(hit.sum())} hits, t within {t_rel:.2e} "
          f"relative", flush=True)
    check(frac >= 0.999 and t_rel <= 1e-5
          and torch.equal(t[miss], rt[miss]),
          ("intersect_only", what, frac, t_rel))
    abs_err = (t - rt).abs()[hit].max().item() if hit.any() else 0.0
    return frac, abs_err, plain_ms


def queue_kernels_vs_plain(name, w, h, n, batch, device, card):
    """[Q1] bounce_steps (4 steps, depth 50) against its plain version on
    n lanes of camera rays, by the rule of tests/test_torch_queue.py at
    the card's own spread (kernel and plain agreed on 99.995% of lanes
    at full size): alive agrees on >= 99.9% of lanes, traced and bounce
    equal there, throughput and pending radiance within 1e-3 on >= 99.5%
    of them. intersect_only (intersect_vs_plain) on the same n camera
    rays, and on `batch` lanes, the batch driver's rays a pass, before
    and after each of 4 bounce steps (all lanes, the dead keeping their
    last ray, as trace_batch passes them)."""
    from rrt_tpu_torch import scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    build = checker_scene if name == "checker" else tscenes.SCENES[name]
    scene, cam = build(w, h)
    st, keys, sph, bg = lane_state(scene, cam, w, h, n, device)
    n_slots = sph.shape[1]
    kw = dict(k_steps=4, max_depth=MAIN["max_depth"], t_min=1e-3)
    out = mk.bounce_steps(st.clone(), keys, sph, bg, **kw)
    ref, plain_ms = wall_ms(
        lambda: mk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw))
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    frac = agree.float().mean().item()
    counts = (torch.equal(out[13][agree], ref[13][agree])
              and torch.equal(out[15][agree], ref[15][agree]))
    err = (out[7:13] - ref[7:13]).abs().amax(dim=0)[agree]
    close = (err < 1e-3).float().mean().item()
    check(frac >= 0.999 and counts and close >= 0.995,
          ("bounce_steps", name, frac, counts, close))
    work, log = torch.empty_like(st), []
    for _ in range(5):  # in place: each launch starts from the same state
        work.copy_(st)
        timed(mk.bounce_steps, log)(work, keys, sph, bg, **kw)
    torch.cuda.synchronize()
    ms = events_ms(log) / len(log)
    segments = int((out[15] - st[15]).sum())
    b_ms, b_by = bound(segments * n_slots * FLOPS_PER_SLOT,
                       4 * (n * (16 + 2 + 16) + 24 * n_slots + 8))
    print(f"  bounce_steps {name} {w}x{h}, {n} lanes, 4 steps: alive "
          f"agrees on {frac:.5f} of lanes, counts equal there, {close:.5f} "
          f"within 1e-3 (max {err.max().item():.3e}); {segments} segments; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
          f"({b_by})  [{card}]", flush=True)

    o, d = st[0:3], st[3:6]
    _, i_err, i_plain_ms = intersect_vs_plain(f"{name} {n} camera rays", o,
                                              d, sph)
    i_ms = cuda_ms(lambda: mk.intersect_only(o, d, sph, t_min=1e-3), 5)
    i_bound = bound(n * n_slots * FLOPS_PER_SLOT,
                    4 * (n * (6 + 3) + 24 * n_slots))
    print(f"  intersect_only {name}, {n} rays: kernel {i_ms:.3f} ms, plain "
          f"{i_plain_ms:.1f} ms, bound {i_bound[0]:.4f} ms ({i_bound[1]})  "
          f"[{card}]", flush=True)
    st_b, keys_b, _, _ = lane_state(scene, cam, w, h, batch, device)
    for depth in range(5):
        if depth:
            mk.bounce_steps(st_b, keys_b, sph, bg, k_steps=1,
                            max_depth=MAIN["max_depth"], t_min=1e-3)
        alive = int((st_b[14] > 0.5).sum())
        _, e, _ = intersect_vs_plain(
            f"{name} batch of {batch} after {depth} bounces ({alive} alive)",
            st_b[0:3], st_b[3:6], sph)
        i_err = max(i_err, e)
    return dict(ms=ms, plain_ms=plain_ms, err=err.max().item(),
                bound=(b_ms, b_by), i_ms=i_ms, i_plain_ms=i_plain_ms,
                i_err=i_err, i_bound=i_bound)


def hold_to_tile(what, image, n_traced, tile_image, tile_traced):
    """The rule of [Q2] and [Q3]: the same paths as tile_render, summed in
    another order, so image means within 0.1%, traced totals within
    0.05%, and >= 95% of pixels within 1e-3."""
    mean, tile_mean = image.mean(dim=(0, 1)), tile_image.mean(dim=(0, 1))
    rel = ((mean - tile_mean).abs() / tile_mean).max().item()
    dt = abs(n_traced - tile_traced) / tile_traced
    err = (image - tile_image).abs().amax(dim=2)
    close = (err < 1e-3).float().mean().item()
    print(f"  {what} vs tile: image means {rel:.5%} apart, traced {n_traced} "
          f"vs {tile_traced} ({dt:.5%}), {close:.5f} of pixels within 1e-3, "
          f"max pixel |delta| {err.max().item():.4f}", flush=True)
    check(rel < 1e-3 and dt < 5e-4 and close >= 0.95,
          (what, rel, dt, close))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from rrt_tpu_torch import cli, diff, render, scenes as tscenes
    from rrt_tpu_torch.ops import _build, megakernel as mk
    from rrt_tpu_torch.ops import megakernel_train as mkt

    t_start = time.perf_counter()
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    built = _build.build()
    print(f"[2] built {os.path.relpath(built.path, REPO)} in "
          f"{built.seconds:.1f} s\n{built.log.strip()}", flush=True)

    print("[3] kernel vs plain version on the card", flush=True)
    # 64x32, 4 spp, depth 8: the tolerance of tests/test_torch_slice.py.
    (rad, traced), (ref, ref_traced), _, _ = compare(
        mk, tscenes, device, card, width=64, height=32, spp=4, max_depth=8)
    close = ((rad - ref).abs().max(dim=1).values / 4 < 1e-3).float().mean()
    dt = abs(int(traced.sum()) - int(ref_traced.sum())) / int(
        ref_traced.sum())
    print(f"  64x32: {close.item():.4f} of pixels within 1e-3, traced "
          f"totals {dt:.4%} apart", flush=True)
    check(close.item() >= 0.985 and dt < 1e-2, (close.item(), dt))
    # Depth 50: about 0.13% of paths part ways between two float
    # implementations (1% of 8-spp pixels at 240x160), so at 32 spp
    # about 4% of pixels hold one; the image means and traced totals
    # must agree within 1%, and 90% of pixels within 1e-3.
    for w, h, spp in ((240, 160, 8),
                      (MAIN["width"], MAIN["height"], MAIN["spp"])):
        (rad, traced), (ref, ref_traced), ms, plain_ms = compare(
            mk, tscenes, device, card, width=w, height=h, spp=spp,
            max_depth=MAIN["max_depth"], repeats=3)
        mean_k = rad.mean(dim=0) / spp
        mean_p = ref.mean(dim=0) / spp
        rel = ((mean_k - mean_p).abs() / mean_p).max().item()
        nt, nr = int(traced.sum()), int(ref_traced.sum())
        err = (rad - ref).abs().max(dim=1).values / spp
        close = (err < 1e-3).float().mean().item()
        max_err = err.max().item()
        print(f"  {w}x{h}: image means {mean_k.tolist()} vs "
              f"{mean_p.tolist()} ({rel:.4%} apart), traced {nt} vs {nr}, "
              f"{close:.4f} of pixels within 1e-3, max pixel |delta| "
              f"{max_err:.4f}", flush=True)
        check(rel < 1e-2 and abs(nt - nr) / nr < 1e-2 and close >= 0.9,
              (rel, nt, nr, close))
    kernel_ms, main_plain_ms, main_err = ms, plain_ms, max_err
    n_slots = tscenes.chap12_scene(8, 8)[0].n_spheres
    n_pix = MAIN["width"] * MAIN["height"]
    main_bound = bound(nt * n_slots * FLOPS_PER_SLOT,
                       4 * (24 * n_slots + 24 + 8) + n_pix * (12 + 4))

    print("[4] main path: rrt_tpu_torch.cli, chap12 1200x800 32spp d50",
          flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "chip_smoke_chap12.png")
    argv = ["--scene", MAIN["scene"], "-r",
            f"{MAIN['width']}x{MAIN['height']}", "-s", str(MAIN["spp"]),
            "-e", "0", "--max-depth", str(MAIN["max_depth"]),
            "--device", "cuda:0", "--quiet"]
    with tempfile.TemporaryDirectory() as tmp:  # warm-up run
        cli.render(cli.build_parser().parse_args(
            argv + ["-o", os.path.join(tmp, "warm.png")]))
    if os.path.exists(png):
        os.remove(png)
    mk.render_tiles.launches = 0
    res = cli.render(cli.build_parser().parse_args(argv + ["-o", png]))
    launches = mk.render_tiles.launches
    img = res.image
    n_paths = MAIN["width"] * MAIN["height"] * MAIN["spp"]
    nonzero = (img.amax(dim=2) > 0).float().mean().item()
    print(f"  {res.seconds:.4f} s wall, {res.n_traced} rays, "
          f"{res.n_traced / res.seconds / 1e6:.2f} Mrays/s, kernel "
          f"launches {launches}, non-zero pixels {nonzero:.4f}  [{card}]",
          flush=True)
    check(launches >= 1, "the main path did not launch the kernel")
    check(bool(torch.isfinite(img).all()), "non-finite pixels")
    check(n_paths <= res.n_traced <= n_paths * (MAIN["max_depth"] + 1),
          ("traced", res.n_traced))
    check(nonzero > 0.99, ("non-zero pixels", nonzero))
    check(os.path.getsize(png) > 0, "empty PNG")
    check(res.n_traced == MAIN_TRACED, ("traced", res.n_traced, MAIN_TRACED))
    tile_image = img

    print("[5] train kernels vs tile_render and their plain versions",
          flush=True)
    train_vs_plain("chap12", 240, 160, 2, 50, device, card)
    train_vs_plain("checker", 64, 32, 4, 8, device, card)
    # At [7]'s shape. A path parts ways with the plain version with odds
    # near 0.4% (240x160, 2 spp: 99.25% of pixels agree), so a pixel of
    # 8 samples holds one with odds near 3%: the pixel share required is
    # 1 - 8 x 0.5%, and 99.5% of paths must agree.
    t5 = train_vs_plain("chap12", TRAIN["width"], TRAIN["height"],
                        TRAIN["spp"], TRAIN["max_depth"], device, card,
                        min_pixels=0.96, min_paths=0.995,
                        plain_chunk=1 << 19)

    print("[6] finite differences at chap12 1200x800 8spp d50", flush=True)
    finite_differences(device, card)

    print("[7] main path: rrt_tpu_torch.diff.make_train_step, chap12 "
          "1200x800 8spp d50, 3 SGD steps", flush=True)
    cfg = render.RenderConfig(**TRAIN)
    scene, cam = tscenes.chap12_scene(cfg.width, cfg.height)
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=device)
    tex = ground_texture(scene)
    color1 = scene.tex_color1.clone()
    color1[tex] += 0.1
    start = diff.combine(scene, {"tex_color1": color1,
                                 "bg_top": scene.bg_top * 0.8})
    # Gradients of the start (a warm-up, outside the counted run).
    loss0, gp, gc = diff.loss_and_grads(cfg, start, cam, target, 0,
                                        device=device)
    check(bool(torch.isfinite(loss0)), "non-finite loss")
    for key, g in list(gp.items()) + [("camera", g) for g in gc]:
        check(bool(torch.isfinite(g).all()), ("non-finite gradient", key))
    for key in ("sphere_c0", "sphere_radius", "tex_color1", "mat_fuzz",
                "mat_ior", "bg_top"):
        check(gp[key].abs().max().item() > 0, ("zero gradient", key))
    check(gc[0].abs().max().item() > 0, "zero gradient: look_from")
    step = diff.make_train_step(cfg, device=device)  # lr 1e-2, as rrt_tpu
    # CUDA events around the autograd Function's forward (train_fwd) and
    # backward (train_bwd); the launch counts stay on the wrappers.
    fwd_fn, bwd_fn = mkt.render_tiles_train, mkt.tiles_adjoint
    chain = mkt.TileTrainChain
    chain_fwd, chain_bwd = chain.forward, chain.backward
    fwd_log, bwd_log = [], []
    chain.forward = staticmethod(timed(chain_fwd, fwd_log))
    chain.backward = staticmethod(timed(chain_bwd, bwd_log))
    s_scene, s_cam = start, cam
    fwd_fn.launches = bwd_fn.launches = 0
    bwd_fn.replay_mismatches = 0
    step_ms = []
    for i in range(3):
        fwd_log.clear()
        bwd_log.clear()
        (s_scene, s_cam, loss), ms = wall_ms(
            lambda: step(s_scene, s_cam, target, 0))
        step_ms.append((events_ms(fwd_log), events_ms(bwd_log), ms))
        print(f"  step {i}: loss {loss.item():.6e}, forward "
              f"{step_ms[-1][0]:.2f} ms, backward {step_ms[-1][1]:.2f} ms, "
              f"total {ms:.2f} ms  [{card}]", flush=True)
        check(bool(torch.isfinite(loss)), ("non-finite loss", i))
    fwd_launches, bwd_launches = fwd_fn.launches, bwd_fn.launches
    mismatches = int(bwd_fn.replay_mismatches)
    print(f"  launches: train_fwd {fwd_launches}, train_bwd {bwd_launches}; "
          f"replay_mismatches {mismatches}; "
          f"ground albedo {start.tex_color1[tex].tolist()} -> "
          f"{s_scene.tex_color1[tex].tolist()} (true "
          f"{scene.tex_color1[tex].tolist()})", flush=True)
    check(fwd_launches >= 3 and bwd_launches >= 3,
          ("the train step did not launch the kernels", fwd_launches,
           bwd_launches))
    check(mismatches == 0, ("replay_mismatches", mismatches))
    check(not torch.equal(s_scene.tex_color1.cpu(), start.tex_color1)
          and not torch.equal(s_scene.bg_top.cpu(), start.bg_top),
          "the parameters did not move")
    print("  one more step under torch.profiler:", flush=True)
    device_breakdown(lambda: step(start, cam, target, 0), card)

    print(f"[8] north star: make_train_step at 1200x800 "
          f"{NORTH_STAR_SPP}spp d50 (the chunked trainer)", flush=True)
    cfg_ns = dataclasses.replace(cfg, spp=NORTH_STAR_SPP)
    chunk = diff.resolve_spp_chunk(cfg_ns, device=device)
    step_ns = diff.make_train_step(cfg_ns, device=device)
    check(step_ns.__qualname__.startswith("make_train_step_chunked"),
          "500 spp did not route to the chunked trainer")
    fwd_fn.launches = bwd_fn.launches = 0
    bwd_fn.replay_mismatches = 0
    fwd_log.clear()
    bwd_log.clear()
    torch.cuda.reset_peak_memory_stats(device)  # the step's peak alone
    (_, _, loss_ns), ns_ms = wall_ms(lambda: step_ns(start, cam, target, 0))
    chain.forward = staticmethod(chain_fwd)
    chain.backward = staticmethod(chain_bwd)
    ns_mismatches = int(bwd_fn.replay_mismatches)
    print(f"  chunk {chunk} spp, loss {loss_ns.item():.6e}, wall "
          f"{ns_ms / 1e3:.3f} s (forward {events_ms(fwd_log):.1f} ms, "
          f"backward {events_ms(bwd_log):.1f} ms), launches train_fwd "
          f"{fwd_fn.launches} train_bwd {bwd_fn.launches}, "
          f"replay_mismatches {ns_mismatches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{card}]",
          flush=True)
    check(bool(torch.isfinite(loss_ns)) and fwd_fn.launches >= 1
          and bwd_fn.launches >= 1, "north-star step")
    check(ns_mismatches == 0, ("replay_mismatches", ns_mismatches))
    print("  one more north-star step under torch.profiler:", flush=True)
    device_breakdown(lambda: step_ns(start, cam, target, 0), card)
    l1, gp1, gc1 = diff.loss_and_grads(cfg, start, cam, target, 0,
                                       device=device)
    l4, gp4, gc4 = diff.loss_and_grads_chunked(cfg, start, cam, target, 0,
                                               spp_chunk=4, device=device)
    # Each partition() field against its largest gradient, the camera
    # fields against the largest camera gradient (tests/test_torch_train.py).
    cam_max = max(g.abs().max().item() for g in gc1)
    worst = 0.0
    for a, b in [(gp4[k], gp1[k]) for k in gp1]:
        scale = max(b.abs().max().item(), 1e-30)
        worst = max(worst, (a - b).abs().max().item() / scale)
    for a, b in zip(gc4, gc1):
        worst = max(worst, (a - b).abs().max().item() / cam_max)
    print(f"  chunked (spp_chunk=4) vs one-shot at 8 spp: losses "
          f"{l4.item():.8e} / {l1.item():.8e}, gradients within "
          f"{worst:.2e} relative", flush=True)
    check(worst < 1e-4 and abs(l4.item() - l1.item()) <= 1e-6 * l1.item(),
          ("chunked vs one-shot", worst))

    print("[Q1] bounce_steps and intersect_only vs their plain versions "
          "on the card", flush=True)
    q1 = queue_kernels_vs_plain("chap12", MAIN["width"], MAIN["height"],
                                QUEUE_LANES, BATCH_RAYS, device, card)
    queue_kernels_vs_plain("checker", 64, 32, 64 * 32, 64 * 32, device,
                           card)

    print(f"[Q2] main path: the queue driver through rrt_tpu_torch.cli, "
          f"chap12 1200x800 32spp d50, --spp-chunk {QUEUE_CHUNK}",
          flush=True)
    argv_q = argv + ["--driver", "queue", "--spp-chunk", str(QUEUE_CHUNK)]
    with tempfile.TemporaryDirectory() as tmp:  # warm-up run
        warm = cli.render(cli.build_parser().parse_args(
            argv_q + ["-o", os.path.join(tmp, "warm.png")]))
    png_q = os.path.join(OUT_DIR, "chip_smoke_chap12_queue.png")
    mk.bounce_steps.launches = 0
    render.trace_queue.outer_steps = 0
    res_q = cli.render(cli.build_parser().parse_args(argv_q + ["-o", png_q]))
    q_launches = mk.bounce_steps.launches
    outer_steps = render.trace_queue.outer_steps
    print(f"  {res_q.seconds:.4f} s wall, {res_q.passes} passes, "
          f"{res_q.n_traced} rays, {res_q.n_traced / res_q.seconds / 1e6:.2f} "
          f"Mrays/s, bounce_steps launches {q_launches}, outer steps "
          f"{outer_steps}  [{card}]", flush=True)
    check(q_launches >= 1, "the queue driver did not launch bounce_steps")
    check(res_q.driver == "queue" and res_q.passes == 4, "queue passes")
    check(bool(torch.isfinite(res_q.image).all()), "non-finite pixels")
    repeat = (warm.image - res_q.image).abs().max().item()
    print(f"  same-seed queue renders: bitwise equal "
          f"{torch.equal(warm.image, res_q.image)}, max |delta| {repeat:.3e}, "
          f"traced {warm.n_traced} and {res_q.n_traced}", flush=True)
    check(warm.n_traced == res_q.n_traced and repeat < 1e-4,
          ("queue repeatability", repeat))
    hold_to_tile("queue", res_q.image, res_q.n_traced, tile_image,
                         MAIN_TRACED)
    print(f"  one {QUEUE_CHUNK}-spp pass of trace_queue under torch.profiler:",
          flush=True)
    cfg_q = render.RenderConfig(width=MAIN["width"], height=MAIN["height"],
                                spp=MAIN["spp"], max_depth=MAIN["max_depth"],
                                queue_size=QUEUE_LANES)
    scene_q, cam_q = tscenes.chap12_scene(cfg_q.width, cfg_q.height)
    ids = torch.arange(n_pix)
    before = render.trace_queue.outer_steps
    rows, busy, wall = device_breakdown(lambda: render.trace_queue(
        scene_q, cam_q, ids % cfg_q.width, ids // cfg_q.width, cfg_q, 0, 0,
        QUEUE_CHUNK, device=device), card)
    n_out = render.trace_queue.outer_steps - before
    k_ms = sum(t for key, t, _ in rows if "bounce_steps" in key)
    print(f"  per outer step ({n_out}): wall {wall / n_out:.3f} ms, device "
          f"busy {busy / n_out:.3f} ms (bounce_steps_kernel "
          f"{k_ms / n_out:.3f} ms), device idle {(wall - busy) / n_out:.3f} "
          f"ms  [{card}]", flush=True)

    print(f"[Q3] main path: the batch driver through rrt_tpu_torch.cli, "
          f"chap12 1200x800 {BATCH_SPP}spp d50", flush=True)
    argv_b = ["--scene", MAIN["scene"], "-r",
              f"{MAIN['width']}x{MAIN['height']}", "-s", str(BATCH_SPP),
              "-e", "0", "--max-depth", str(MAIN["max_depth"]), "--driver",
              "batch", "--device", "cuda:0", "--quiet"]
    png_b = os.path.join(OUT_DIR, "chip_smoke_chap12_batch.png")
    mk.intersect_only.launches = 0
    res_b = cli.render(cli.build_parser().parse_args(argv_b + ["-o", png_b]))
    b_launches = mk.intersect_only.launches
    print(f"  {res_b.seconds:.4f} s wall, {res_b.n_traced} rays, "
          f"{res_b.n_traced / res_b.seconds / 1e6:.2f} Mrays/s, "
          f"intersect_only launches {b_launches}  [{card}]", flush=True)
    check(b_launches >= 1, "the batch driver did not launch intersect_only")
    check(bool(torch.isfinite(res_b.image).all()), "non-finite pixels")
    cfg_b = render.RenderConfig(width=MAIN["width"], height=MAIN["height"],
                                spp=BATCH_SPP, max_depth=MAIN["max_depth"])
    tile_b, tile_b_traced = render.render_image_tiles(
        scene_q, cam_q, cfg_b, 0, device=device)
    hold_to_tile("batch", res_b.image, res_b.n_traced, tile_b,
                 int(tile_b_traced))
    # The middle tile (rows 395-409: spheres and ground); the first is
    # all sky and ends after one bounce step.
    print("  the middle tile of the batch render under torch.profiler:",
          flush=True)
    scene_d, cam_d = scene_q.to(device), cam_q.to(device)
    cfg_b = dataclasses.replace(cfg_b, samples_per_pass=BATCH_SPP)
    tiles = render._tile_coords(cfg_b, device)
    px, py = tiles[len(tiles) // 2]
    before = mk.intersect_only.launches
    rows, busy, wall = device_breakdown(lambda: render.render_tile(
        scene_d, cam_d, px, py, cfg_b, 0, 0, 1), card)
    n_bounce = mk.intersect_only.launches - before
    k_ms = sum(t for key, t, _ in rows if "intersect_kernel" in key)
    print(f"  per bounce step ({n_bounce}, {px.numel() * BATCH_SPP} rays): "
          f"wall {wall / n_bounce:.3f} ms, device busy {busy / n_bounce:.3f} "
          f"ms (intersect_kernel {k_ms / n_bounce:.3f} ms)  [{card}]",
          flush=True)

    main_fwd = sum(m[0] for m in step_ms) / len(step_ms)
    main_bwd = sum(m[1] for m in step_ms) / len(step_ms)
    print(f"[9] total wall {time.perf_counter() - t_start:.1f} s", flush=True)
    # ms / plain_ms / bound_ms: the same shape for each (tile_render at
    # MAIN, the train kernels at [5]'s chap12 1200x800, 8 spp, depth 50,
    # bounce_steps and intersect_only at [Q1]'s chap12 131072 lanes;
    # intersect_only's max_abs_err also covers [Q1]'s batch rays);
    # main_ms: the train kernels' mean per step of [7] (the same shape).
    # No single PyTorch call computes any of these functions.
    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                **extra}

    csrc = "rrt_tpu_torch/ops/csrc/"
    print(json.dumps({"kernels": [
        entry("tile_render", csrc + "tile_render.cu",
              "rrt_tpu/ops/megakernel.py:2048", launches, main_err,
              kernel_ms, main_plain_ms, main_bound),
        entry("train_fwd", csrc + "train.cu",
              "rrt_tpu/ops/megakernel_train.py:376", fwd_launches,
              t5["fwd_err"], t5["fwd_ms"], t5["fwd_plain_ms"],
              t5["fwd_bound"], main_ms=main_fwd),
        entry("train_bwd", csrc + "train.cu",
              "rrt_tpu/ops/megakernel_train.py:463", bwd_launches,
              t5["bwd_err"], t5["bwd_ms"], t5["bwd_plain_ms"],
              t5["bwd_bound"], main_ms=main_bwd),
        entry("bounce_steps", csrc + "queue.cu",
              "rrt_tpu/ops/megakernel.py:645", q_launches, q1["err"],
              q1["ms"], q1["plain_ms"], q1["bound"]),
        entry("intersect_only", csrc + "queue.cu",
              "rrt_tpu/ops/megakernel.py:1683", b_launches, q1["i_err"],
              q1["i_ms"], q1["i_plain_ms"], q1["i_bound"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
