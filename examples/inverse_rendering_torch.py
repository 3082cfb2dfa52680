"""Inverse rendering with the PyTorch/CUDA port: recover material
parameters from a target image.

The port's counterpart of examples/inverse_rendering.py. Renders a
ground-truth image, perturbs both albedos, then optimizes them back with
Adam over the differentiable render (diff.render_loss: the train kernels
on a CUDA device, their plain PyTorch versions on the CPU). Material
gradients are exact interior gradients; geometry gradients are
silhouette-blind by construction (detached sampling), so geometry
recovery needs an edge-aware loss and is out of scope here:

    python examples/inverse_rendering_torch.py [--device cpu] [--steps N]
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                    "kernels' plain PyTorch versions)")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args()

    from rrt_tpu_torch.camera import Camera
    from rrt_tpu_torch.diff import partition, render_loss
    from rrt_tpu_torch.render import RenderConfig, render_image_diff
    from rrt_tpu_torch.scene import SceneBuilder

    device = torch.device(args.device)
    cfg = RenderConfig(width=48, height=32, spp=8, max_depth=5,
                       tile_pixels=48 * 32, samples_per_pass=4)

    def make_scene(albedo, center):
        b = SceneBuilder()
        b.sphere(center, 0.5, b.lambertian(albedo))
        b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
        return b.build()

    cam = Camera.create(look_from=(0.0, 0.2, 1.0), look_at=(0.0, 0.0, -1.0),
                        fov_deg=55.0, aspect=cfg.width / cfg.height)

    truth = make_scene((0.7, 0.2, 0.1), (0.0, 0.0, -1.0))
    with torch.no_grad():
        target, _ = render_image_diff(truth, cam, cfg, 0, device=device)

    scene = make_scene((0.2, 0.5, 0.6), (0.0, 0.0, -1.0)).to(device)
    full = {k: v.detach() for k, v in partition(scene).items()}
    albedo = full["tex_color1"].clone().requires_grad_()  # albedos only
    opt = torch.optim.Adam([albedo], lr=5e-2)

    t0 = time.time()
    for i in range(args.steps):
        opt.zero_grad()
        loss = render_loss({**full, "tex_color1": albedo}, cam, scene,
                           target, cfg, 0, None, device=device)
        loss.backward()
        opt.step()
        with torch.no_grad():
            albedo.clamp_(0.0, 1.0)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}  albedo "
                  f"{[round(v, 3) for v in albedo[0].tolist()]}", flush=True)

    a = [round(v, 3) for v in albedo[0].tolist()]
    g = [round(v, 3) for v in albedo[1].tolist()]
    print(f"\nrecovered sphere albedo {a} (truth 0.7 0.2 0.1)")
    print(f"recovered ground albedo {g} (truth 0.5 0.5 0.5)")
    print(f"{args.steps} fwd+bwd steps in {time.time() - t0:.1f}s on {device}")


if __name__ == "__main__":
    main()
