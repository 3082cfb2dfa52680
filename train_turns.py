"""Time the train kernels of checkouts of this repository in turns.

    python train_turns.py TREE_A [TREE_B ...] [--order ABBA] \
        [--north-star] [--check] [--forward] [--queue] [--no-train]

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
tree's own chip_smoke.train_vs_plain at [5]'s two small shapes. With
--forward also the forward kernels: tile_render at chip_smoke.py [4]'s
shape (1200x800, 32 spp, depth 50, seed 0) on chap12 and book2chap2 (the
mean of 3 launches after a warm one, its traced total and a digest of
its radiance), and intersect_only at [Q1]'s (131,072 camera rays and the
same lanes after 1-4 bounce steps, the mean of GRAPH_LAUNCHES replayed
launches each). With --queue the queue and chain kernels:
bounce_steps at chip_smoke.py [Q1]'s shape (131,072 camera rays of
1200x800, 4 steps, depth 50; the mean of 10 launches on a fresh copy of
the state each) with a digest of its whole output state; chain_bwd on
[C1]'s three chains ([C2]'s 262,144 lanes, chains 4, 4, 43, each chain's
input the kernels' forward of the one before, compacted; a seeded
normal output cotangent; GRAPH_LAUNCHES replayed launches each) with
digests of its input and background cotangents, its replay mismatches
and its pack cotangents, which the calling process holds against the
first turn's (the largest |delta| over the largest); [C2]'s gradient
step (its loss, bit for bit, traced count, median wall of 3 after a
warm one, and each step's wall and host time in the chain's BVH pack,
chip_smoke.pack_clock, where the tree has it); and [C3]'s differentiable batch render with the gradient of
its loss (chip_smoke.batch_loss_and_grads at 1200x800, BATCH_SPP spp:
its loss and wall after a warm one); on chap12 and book2chap2.
--no-train skips the train kernels. The default order is ABBA for two
trees and AAA for one, so that two versions are compared within one
call, on one card; with more trees, --order names them (A, B, C, ...).

It works with the train wrappers before and after the winners residual:
render_tiles_train's outputs after the traced counts are the residual,
handed to tiles_adjoint as they come; and with the forward and queue
wrappers before and after the BVH walk (a tree without
rrt_tpu_torch/accel.py, or whose bounce_steps takes no `bvh`, scans).
"""

import hashlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

SHAPE = dict(width=1200, height=800, spp=8, max_depth=50)
FORWARD_SHAPE = dict(width=1200, height=800, spp=32, max_depth=50)
CAPACITIES = (4, 8, 12, 16, 24)
MIX = (1.0, 0.7, 0.3)


def _forward(out: dict) -> None:
    """tile_render at [4]'s shape and intersect_only at [Q1]'s, on
    chap12 and book2chap2, into out[name]. A tree without
    rrt_tpu_torch/accel.py scans, and its wrappers take no BVH."""
    import importlib.util
    import torch
    import chip_smoke as cs
    from rrt_tpu_torch import render, scenes
    from rrt_tpu_torch.ops import megakernel as mk

    dev = torch.device("cuda:0")
    walks = importlib.util.find_spec("rrt_tpu_torch.accel") is not None
    cfg = render.RenderConfig(**FORWARD_SHAPE)
    for name in ("chap12", "book2chap2"):
        scene, cam = scenes.SCENES[name](cfg.width, cfg.height)
        packs = [p.detach() for p in render._packs(scene, cam, cfg, dev)]
        tree = {}
        if walks:
            tree = dict(bvh=render._packs(scene, cam, cfg, dev,
                                          bvh=True)[3])
        kw = dict(seed_words=(0, 0), sample_lo=0, width=cfg.width,
                  height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
                  t_min=cfg.t_min, moving=scene.has_moving, **tree)
        rad, traced = mk.render_tiles(*packs, **kw)
        tile_ms = cs.cuda_ms(lambda: mk.render_tiles(*packs, **kw), 3)
        st, keys, sph, bg = cs.lane_state(scene, cam, cfg.width, cfg.height,
                                          cs.QUEUE_LANES, dev)
        if walks:
            tree = dict(bvh=render.pack_scene(
                scene, dev, render._shutter(cam))["bvh"])
        steps_tree = (tree if "bvh" in inspect.signature(
            mk.bounce_steps).parameters else {})
        i_ms = []
        for depth in range(5):
            if depth:
                mk.bounce_steps(st, keys, sph, bg, k_steps=1,
                                max_depth=cfg.max_depth, t_min=cfg.t_min,
                                moving=scene.has_moving, **steps_tree)
            o, d, tm = st[0:3], st[3:6], st[6].contiguous()
            i_ms.append(cs.graph_ms(lambda: mk.intersect_only(
                o, d, sph, t_min=cfg.t_min,
                time=tm if scene.has_moving else None, **tree),
                mk.intersect_only))
        out.setdefault(name, {}).update(
            tile_ms=tile_ms, tile_traced=int(traced.sum()),
            tile_rad_sum=float(rad.double().sum()),
            intersect_ms=i_ms)


def _digest(t) -> str:
    """A digest of a tensor's bytes."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def _queue(out: dict, save: str) -> None:
    """bounce_steps at [Q1]'s shape, chain_bwd at [C1]'s three chains and
    [C2]'s step, on chap12 and book2chap2, into out[name]; each chain's
    pack cotangents saved as save/<name>_<chain>.npy."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from rrt_tpu_torch import diff, render, rng, scenes
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.ops import megakernel_vjp as mkv

    dev = torch.device("cuda:0")
    walks = "bvh" in inspect.signature(mk.bounce_steps).parameters
    w, h = cs.MAIN["width"], cs.MAIN["height"]
    for name in ("chap12", "book2chap2"):
        scene, cam = scenes.SCENES[name](w, h)
        moving = scene.has_moving
        st, keys, sph, bg = cs.lane_state(scene, cam, w, h, cs.QUEUE_LANES,
                                          dev)
        tree = {}
        if walks:
            tree = dict(bvh=render.pack_scene(
                scene, dev, render._shutter(cam))["bvh"])
        kw = dict(k_steps=4, max_depth=cs.MAIN["max_depth"], t_min=1e-3,
                  moving=moving, **tree)
        work, log = st.clone(), []
        mk.bounce_steps(work, keys, sph, bg, **kw)
        state_digest = _digest(work)
        for _ in range(10):  # in place: each launch from the same state
            work.copy_(st)
            cs.timed(mk.bounce_steps, log)(work, keys, sph, bg, **kw)
        torch.cuda.synchronize()
        steps_ms = cs.events_ms(log) / len(log)

        scene, cam, cfg, px, py, kc = cs.chain_rays(dev, name)
        sph = mk.pack_spheres_full(scene).to(dev)
        n = px.shape[0]
        o, d, tm = render.generate_rays(cam.to(dev), px, py, cfg.width,
                                        cfg.height, kc)
        if walks:
            tree = dict(bvh=render.chain_bvh(sph, tm, moving))
        one = torch.ones((n,), device=dev)
        zero = torch.zeros((n,), device=dev)
        cst = mk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n),
                            zero, one, zero)
        kbits, lane = rng.u32_bits(kc), torch.arange(n, device=dev)
        chains = []
        for j, k_steps in enumerate(render._fused_schedule(cfg.max_depth)):
            ckw = dict(kw, k_steps=k_steps, **tree)
            res = mk.bounce_steps(cst.clone(), kbits, sph, bg, **ckw)
            gen = torch.Generator().manual_seed(k_steps)
            d_out = torch.randn(tuple(cst.shape), generator=gen).to(dev)
            ob = res[mk.ROW_BOUNCE].clone()
            g = mkv.chain_adjoint(cst, kbits, sph, bg, d_out, ob, **ckw)
            ms = cs.graph_ms(lambda: mkv.chain_adjoint(
                cst, kbits, sph, bg, d_out, ob, **ckw), mkv.chain_adjoint)
            np.save(os.path.join(save, f"{name}_{j}.npy"),
                    g[1].cpu().numpy())
            chains.append(dict(k=k_steps, ms=ms, d_state=_digest(g[0]),
                               d_bg=_digest(g[2]), mismatches=int(g[3]),
                               segments=int((res[mk.ROW_TRACED]
                                             - cst[mk.ROW_TRACED]).sum())))
            cst, kbits, lane = render._compact_lanes(res, kbits, lane)

        def step():
            scene_d, params, camera = diff._leaves(scene, cam, dev)
            o, d, tm = render.generate_rays(camera, px, py, cfg.width,
                                            cfg.height, kc)
            rad, n = render.trace_batch(scene_d, o, d, tm, kc,
                                        cfg.max_depth, 1e-3,
                                        differentiable=True, fused_vjp=True)
            loss = rad[0].mean() + rad[1].mean() + rad[2].mean()
            diff._grads(loss, params, camera)
            return loss.detach(), int(n)

        step()  # warm-up
        runs, packs = [], []
        clock = getattr(cs, "pack_clock", None)  # trees before it: no pack
        for _ in range(3):
            if clock is None:
                runs.append(cs.wall_ms(step))
                continue
            with clock() as (chain_log, build_log):
                runs.append(cs.wall_ms(step))
            packs.append((sum(chain_log), sum(build_log)))
        (loss, traced), _ = runs[0]

        cfg = render.RenderConfig(width=w, height=h, spp=cs.BATCH_SPP,
                                  max_depth=cs.MAIN["max_depth"],
                                  samples_per_pass=cs.BATCH_SPP)
        target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=dev)
        cs.batch_loss_and_grads(cfg, scene, cam, target, 0, dev)  # warm-up
        c3, c3_ms = cs.wall_ms(lambda: cs.batch_loss_and_grads(
            cfg, scene, cam, target, 0, dev))
        out.setdefault(name, {}).update(
            bounce_steps_ms=steps_ms, state_digest=state_digest,
            chains=chains, chain_ms=sum(c["ms"] for c in chains),
            c2_loss=float(loss).hex(), c2_traced=traced,
            c2_step_ms=sorted(r[1] for r in runs)[1],
            c2_steps_ms=[r[1] for r in runs],
            c2_pack_ms=[p[0] for p in packs],
            c2_build_ms=[p[1] for p in packs],
            c3_loss=float(c3[2]).hex(), c3_ms=c3_ms)


def _turn(tree: str, north_star: bool, check: bool, forward: bool,
          train: bool, queue: str | None = None) -> dict:
    sys.path.insert(0, tree)  # ahead of this script's own directory
    import torch
    import chip_smoke as cs
    from rrt_tpu_torch import diff, render, scenes
    from rrt_tpu_torch.ops import _build, megakernel_train as mkt

    dev = torch.device("cuda:0")
    resources = getattr(_build, "kernel_resources", None)
    out = dict(card=cs.card_line(),
               ptxas=resources(_build.build().log) if resources else None)
    if forward:
        _forward(out)
    if queue:
        _queue(out, queue)
    if not train:
        return out
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
        out.setdefault(name, {}).update(
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
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--queue", action="store_true")
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print("TURN " + json.dumps(
            _turn(os.path.abspath(args.trees[0]), args.north_star,
                  args.check, args.forward, not args.no_train, args.save),
            default=str), flush=True)
        return 0
    trees = [os.path.abspath(t) for t in args.trees]
    order = args.order or ("ABBA" if len(trees) > 1 else "AAA")
    flags = [f for f, on in (("--north-star", args.north_star),
                             ("--check", args.check),
                             ("--forward", args.forward),
                             ("--no-train", args.no_train)) if on]
    with tempfile.TemporaryDirectory() as tmp:
        for i, letter in enumerate(order):
            tree = trees[ord(letter) - ord("A")]
            save = os.path.join(tmp, str(i))
            queue = ["--save", save] if args.queue else []
            if queue:
                os.mkdir(save)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn", *flags,
                 *queue, tree], cwd=tree, capture_output=True, text=True,
                env=dict(os.environ, PYTHONPATH=tree), timeout=1800)
            line = next((ln[5:] for ln in proc.stdout.splitlines()
                         if ln.startswith("TURN ")), None)
            if proc.returncode != 0 or line is None:
                print(proc.stdout[-4000:], proc.stderr[-8000:],
                      file=sys.stderr)
                return 1
            print(json.dumps(dict(turn=letter, tree=tree,
                                  wall_s=time.perf_counter() - t0,
                                  **json.loads(line))), flush=True)
            if queue and i:
                print(json.dumps(dict(turn=letter, d_sph_vs_first=_spread(
                    os.path.join(tmp, "0"), save))), flush=True)
    return 0


def _spread(first: str, other: str) -> dict:
    """The largest |delta| of each saved pack cotangent of `other` from
    the same one of `first`, over the largest |value| of `first`'s."""
    import numpy as np
    out = {}
    for name in sorted(os.listdir(first)):
        a = np.load(os.path.join(first, name))
        b = np.load(os.path.join(other, name))
        out[name[:-4]] = float(np.abs(b - a).max()
                               / max(np.abs(a).max(), 1e-30))
    return out


if __name__ == "__main__":
    sys.exit(main())
