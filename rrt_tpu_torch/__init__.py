"""rrt_tpu_torch — the rrt_tpu path tracer ported to PyTorch and CUDA.

The forward render of the book-1 sphere scenes runs through one
hand-written CUDA kernel (ops/csrc/tile_render.cu) on an NVIDIA GPU, and
the differentiable render and training step (diff.py) through two more
(ops/csrc/train.cu); tensors on the CPU take the kernels' plain PyTorch
versions. The JAX
package `rrt_tpu` stays the reference; this package imports neither JAX
nor rrt_tpu.
"""

from .render import RenderConfig, render_image_tiles, tonemap
from .scenes import SCENES

__all__ = ["RenderConfig", "SCENES", "render_image_tiles", "tonemap"]
__version__ = "0.1.0"
