"""Batched texture evaluation: solid and checker.

Branchless select over the texture type for a whole ray batch, as in
rrt_tpu.textures. Perlin and image textures wait for ROADMAP Queue A
#9.5.
"""

import torch

from .scene import TEX_CHECKER, SceneArrays


def use_color2(scene: SceneArrays, tex_id, p):
    """(N,) bool: the checker's odd cells (RTTNW ch. 4.3 sine form),
    where the texture shows color2; False on solid textures. A discrete
    decision, so it carries no gradient."""
    tex_id = tex_id.long()
    scale = scene.tex_scale[tex_id]
    s = (torch.sin(scale * p[0]) * torch.sin(scale * p[1])
         * torch.sin(scale * p[2]))
    return (scene.tex_type[tex_id] == TEX_CHECKER) & (s < 0.0)


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
    return torch.where(use_color2(scene, tex_id, p), c2, c1)
