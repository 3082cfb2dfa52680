"""Batched texture evaluation: solid and checker.

Branchless select over the texture type for a whole ray batch, as in
rrt_tpu.textures. Perlin and image textures wait for ROADMAP Queue A
#9.5.
"""

import torch

from .scene import TEX_SOLID, SceneArrays


def texture_value(scene: SceneArrays, tex_id, u, v, p):
    """Evaluate texture tex_id (N,) at surface uv and point p (3,N) ->
    (3,N). u and v are unused by solid and checker textures."""
    if scene.has_perlin or scene.has_images:
        raise NotImplementedError(
            "perlin and image textures are not ported to rrt_tpu_torch "
            "yet (ROADMAP Queue A #9.5)")
    tex_id = tex_id.long()
    c1 = scene.tex_color1[tex_id].T
    c2 = scene.tex_color2[tex_id].T
    scale = scene.tex_scale[tex_id]
    # Checker (RTTNW ch. 4.3 sine form).
    s = (torch.sin(scale * p[0]) * torch.sin(scale * p[1])
         * torch.sin(scale * p[2]))
    checker = torch.where(s < 0.0, c2, c1)
    return torch.where(scene.tex_type[tex_id] == TEX_SOLID, c1, checker)
