"""Time the train kernels of checkouts of this repository in turns.

    python train_turns.py TREE_A [TREE_B] [--order ABBA] [--north-star] \
        [--check]

Each turn is a fresh process on the card whose `rrt_tpu_torch` (and
`chip_smoke.py`) come from that turn's tree, a directory holding a
checkout (for another commit: `git archive <commit>` unpacked into a
directory that .gitignore lists). It builds that tree's kernels and
prints one JSON line: ptxas's registers and spills of each kernel
(`_build.kernel_resources`, where the tree has it); train_fwd
and train_bwd at the train step's shape (1200x800, 8 spp, depth 50,
seed 0) on chap12 and book2chap2, by CUDA events (the mean of 3 launches
after a warm one); the histogram of path lengths and, for pooled winner
capacities of K entries a sample, the share of segments past them; the
8-spp make_train_step's wall (3 steps after a warm one); with
--north-star the 500-spp step's wall and peak memory; with --check the
tree's own chip_smoke.train_vs_plain at [5]'s two small shapes. The
default order is ABBA for two trees and AAA for one, so that two
versions are compared within one call, on one card.

It works with the train wrappers before and after the winners residual:
render_tiles_train's outputs after the traced counts are the residual,
handed to tiles_adjoint as they come.
"""

import json
import os
import subprocess
import sys
import time

SHAPE = dict(width=1200, height=800, spp=8, max_depth=50)
CAPACITIES = (4, 8, 12, 16, 24)
MIX = (1.0, 0.7, 0.3)


def _turn(tree: str, north_star: bool, check: bool) -> dict:
    sys.path.insert(0, tree)  # ahead of this script's own directory
    import torch
    import chip_smoke as cs
    from rrt_tpu_torch import diff, render, scenes
    from rrt_tpu_torch.ops import _build, megakernel_train as mkt

    dev = torch.device("cuda:0")
    resources = getattr(_build, "kernel_resources", None)
    out = dict(card=cs.card_line(),
               ptxas=resources(_build.build().log) if resources else None)
    cfg = render.RenderConfig(**SHAPE)
    for name in ("chap12", "book2chap2"):
        scene, cam = scenes.SCENES[name](cfg.width, cfg.height)
        packs = [p.detach() for p in render._packs(scene, cam, cfg, dev)]
        kw = dict(seed_words=(0, 0), sample_lo=0, width=cfg.width,
                  height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
                  t_min=cfg.t_min, moving=scene.has_moving)
        fwd = mkt.render_tiles_train(*packs, **kw)
        lengths = fwd[2]
        fwd_ms = cs.cuda_ms(lambda: mkt.render_tiles_train(*packs, **kw), 3)
        n_pix = cfg.width * cfg.height
        weight = torch.sin(torch.arange(n_pix, device=dev) * 0.1)
        d_rad = (weight[:, None] * torch.tensor(MIX, device=dev)).contiguous()
        bwd = mkt.tiles_adjoint(*packs, d_rad, *fwd[2:], **kw)
        bwd_ms = cs.cuda_ms(
            lambda: mkt.tiles_adjoint(*packs, d_rad, *fwd[2:], **kw), 3)
        total = lengths.sum(dim=0, dtype=torch.int64)
        segments = int(total.sum())
        past = {k: int((total - k * cfg.spp).clamp(min=0).sum()) / segments
                for k in CAPACITIES}
        out[name] = dict(
            fwd_ms=fwd_ms, bwd_ms=bwd_ms, mismatches=int(bwd[3]),
            segments=segments,
            histogram=torch.bincount(lengths.flatten().long()).tolist(),
            past_capacity=past)
        del fwd, bwd
    scene, cam = scenes.chap12_scene(cfg.width, cfg.height)
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=dev)
    step = diff.make_train_step(cfg, device=dev)
    step(scene, cam, target, 0)
    out["step_ms"] = [cs.wall_ms(lambda: step(scene, cam, target, 0))[1]
                      for _ in range(3)]
    if north_star:
        import dataclasses
        cfg_ns = dataclasses.replace(cfg, spp=500)
        step_ns = diff.make_train_step(cfg_ns, device=dev)
        step_ns(scene, cam, target, 0)
        torch.cuda.reset_peak_memory_stats(dev)
        out["north_star_ms"] = cs.wall_ms(
            lambda: step_ns(scene, cam, target, 0))[1]
        out["north_star_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if check:
        out["check"] = [cs.train_vs_plain("chap12", 240, 160, 2, 50, dev,
                                          out["card"]),
                        cs.train_vs_plain("checker", 64, 32, 4, 8, dev,
                                          out["card"])]
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--order")
    ap.add_argument("--north-star", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print("TURN " + json.dumps(
            _turn(os.path.abspath(args.trees[0]), args.north_star,
                  args.check), default=str), flush=True)
        return 0
    trees = [os.path.abspath(t) for t in args.trees]
    order = args.order or ("ABBA" if len(trees) > 1 else "AAA")
    flags = [f for f, on in (("--north-star", args.north_star),
                             ("--check", args.check)) if on]
    for letter in order:
        tree = trees[ord(letter) - ord("A")]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", *flags,
             tree], cwd=tree, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=tree), timeout=1800)
        line = next((ln[5:] for ln in proc.stdout.splitlines()
                     if ln.startswith("TURN ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        print(json.dumps(dict(turn=letter, tree=tree,
                              wall_s=time.perf_counter() - t0,
                              **json.loads(line))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
