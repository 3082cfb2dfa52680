"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the tile-render kernel from rrt_tpu_torch/ops/csrc with nvcc,
holds it against its plain PyTorch version on the card, then renders
chap12 (RTIOW final, 484 spheres) at 1200x800, 32 spp, depth 50 through
the port's CLI and checks the image. Prints the card's name and power
limit beside every time, a JSON line per kernel, and as its last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA device it exits 2 before printing any result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

MAIN = dict(scene="chap12", width=1200, height=800, spp=32, max_depth=50)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from rrt_tpu_torch import cli, scenes as tscenes
    from rrt_tpu_torch.ops import _build, megakernel as mk

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

    print(json.dumps({"kernels": [{
        "name": "tile_render", "route": "cuda",
        "source": "rrt_tpu_torch/ops/csrc/tile_render.cu",
        "replaces": "rrt_tpu/ops/megakernel.py:2048",
        "launches": launches, "max_abs_err": main_err,
        "ms": kernel_ms, "plain_ms": main_plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
