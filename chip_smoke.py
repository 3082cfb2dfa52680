"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from rrt_tpu_torch/ops/csrc with nvcc and holds each
against its plain PyTorch version on the card. Then drives the two main
paths on chap12 (RTIOW final, 484 spheres), each with the launch counts
set to 0 just before it and read just after:

  [4] the forward render, 1200x800, 32 spp, depth 50, through the CLI;
  [7] training, rrt_tpu_torch.diff.make_train_step at 1200x800, 8 spp,
      depth 50, three SGD steps (train_fwd + train_bwd);
  [8] the 500-spp north-star step, routed to the chunked trainer.

[5] holds the train kernels against their plain versions, at two small
shapes and at [7]'s, and [6] checks their gradients with finite
differences at full size. Prints the
card's name and power limit beside every time, one JSON line of the
kernels, and as its last line {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; without a CUDA device it exits 2
before printing any result.
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
    return dict(fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms, bwd_ms=bwd_ms,
                bwd_plain_ms=bwd_plain_ms, fwd_err=fwd_err, bwd_err=err)


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

    main_fwd = sum(m[0] for m in step_ms) / len(step_ms)
    main_bwd = sum(m[1] for m in step_ms) / len(step_ms)
    print(f"[9] total wall {time.perf_counter() - t_start:.1f} s", flush=True)
    # ms / plain_ms: the same shape for both (tile_render at MAIN, the
    # train kernels at [5]'s chap12 1200x800, 8 spp, depth 50); main_ms:
    # the train kernels' mean per step of [7] (the same shape).
    print(json.dumps({"kernels": [
        {"name": "tile_render", "route": "cuda",
         "source": "rrt_tpu_torch/ops/csrc/tile_render.cu",
         "replaces": "rrt_tpu/ops/megakernel.py:2048",
         "launches": launches, "max_abs_err": main_err,
         "ms": kernel_ms, "plain_ms": main_plain_ms},
        {"name": "train_fwd", "route": "cuda",
         "source": "rrt_tpu_torch/ops/csrc/train.cu",
         "replaces": "rrt_tpu/ops/megakernel_train.py:376",
         "launches": fwd_launches, "max_abs_err": t5["fwd_err"],
         "ms": t5["fwd_ms"], "plain_ms": t5["fwd_plain_ms"],
         "main_ms": main_fwd},
        {"name": "train_bwd", "route": "cuda",
         "source": "rrt_tpu_torch/ops/csrc/train.cu",
         "replaces": "rrt_tpu/ops/megakernel_train.py:463",
         "launches": bwd_launches, "max_abs_err": t5["bwd_err"],
         "ms": t5["bwd_ms"], "plain_ms": t5["bwd_plain_ms"],
         "main_ms": main_bwd}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
