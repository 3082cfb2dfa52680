"""rrt_tpu_torch — the rrt_tpu path tracer ported to PyTorch and CUDA.

The book-1 sphere scenes, book2chap2 and the Cornell box render on an
NVIDIA GPU through three forward drivers, each with its hand-written
CUDA kernel: the tile driver
(`render_image_tiles`, ops/csrc/tile_render.cu), the queue driver
(`render_image_queue` / `trace_queue`, the bounce-steps kernel of
ops/csrc/queue.cu) and the batch driver (`render_image` / `render_tile`
/ `trace_batch`, the intersect kernel of ops/csrc/queue.cu). The
differentiable render and training step (diff.py) run through two more
(ops/csrc/train.cu), or, for the Cornell box's quads, boxes and light,
through the batch driver's checkpointed scan. Tensors on the CPU take
the kernels' plain PyTorch versions. The JAX package `rrt_tpu` stays
the reference; this package imports neither JAX nor rrt_tpu.
"""

from .render import (RenderConfig, render_image, render_image_queue,
                     render_image_tiles, render_tile, tonemap, trace_batch,
                     trace_queue)
from .scenes import SCENES

__all__ = ["RenderConfig", "SCENES", "render_image", "render_image_queue",
           "render_image_tiles", "render_tile", "tonemap", "trace_batch",
           "trace_queue"]
__version__ = "0.1.0"
