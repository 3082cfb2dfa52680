"""Batched texture evaluation: solid, checker, perlin marble and image.

Branchless select over the texture type for a whole ray batch, as in
rrt_tpu.textures. The perlin noise is rrt_tpu's hashed gradient lattice
(RTTNW ch. 5 with a computational hash in place of the permutation
tables), 7 octaves of turbulence modulating the marble's sine; the
image texture is a nearest lookup in the scene's atlas (SceneArrays.
images, every image on one grid). csrc/bounce.cuh evaluates the same
arithmetic in the kernels, so the plain versions, which shade through
here, give the kernels' albedo.
"""

import torch

from .scene import TEX_CHECKER, TEX_IMAGE, TEX_PERLIN, TEX_SOLID, SceneArrays

_MASK32 = 0xFFFFFFFF
# The hash's odd constants (rrt_tpu.textures._lattice_grad).
_HX, _HY, _HZ, _HMIX = 0x8DA6B343, 0xD8163841, 0xCB1AB31F, 0x85EBCA6B
# Octaves of turbulence (RTTNW ch. 5.6).
TURB_DEPTH = 7


def _mul32(a, c: int):
    """(a * c) mod 2^32 for int64 tensors a in [0, 2^32): torch has no
    uint32 product on the CPU, and a whole product would pass 2^63, so
    c is split into its 16-bit halves."""
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (hi + a * (c & 0xFFFF)) & _MASK32


def lattice_grad(ix, iy, iz):
    """The unit-ish gradient at integer lattice points (int tensors, any
    sign): rrt_tpu's u32 hash, computed in int64 and masked to wrap as
    uint32 does. Returns (gx, gy, gz) float32."""
    u = lambda x: x.to(torch.int64) & _MASK32
    h = (_mul32(u(ix), _HX) + _mul32(u(iy), _HY) + _mul32(u(iz), _HZ)) \
        & _MASK32
    h = h ^ (h >> 13)
    h = _mul32(h, _HMIX)
    h = h ^ (h >> 16)
    scale = 2.0 / 1024.0
    gx = (h & 1023).to(torch.float32) * scale - 1.0
    gy = ((h >> 10) & 1023).to(torch.float32) * scale - 1.0
    gz = ((h >> 20) & 1023).to(torch.float32) * scale - 1.0
    inv = torch.rsqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-6))
    return gx * inv, gy * inv, gz * inv


def perlin_noise(px, py, pz):
    """Gradient-lattice noise in [-1, 1] at points (px, py, pz), each
    (N,): the hermite-smoothed trilinear blend of the 8 corners'
    gradient dots. floor() and the hash carry no gradient; autograd
    differentiates the rest."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ux, uy, uz = px - fx, py - fy, pz - fz
    i, j, k = (f.to(torch.int64) for f in (fx, fy, fz))
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)
    acc = torch.zeros_like(px)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                gx, gy, gz = lattice_grad(i + di, j + dj, k + dk)
                dotv = gx * (ux - di) + gy * (uy - dj) + gz * (uz - dk)
                w = ((sx if di else 1.0 - sx) * (sy if dj else 1.0 - sy)
                     * (sz if dk else 1.0 - sz))
                acc = acc + w * dotv
    return acc


def perlin_turb(px, py, pz, depth: int = TURB_DEPTH):
    """Turbulence: the sum of |noise| over octaves, octave k at 2^k p
    with weight 0.5^k (RTTNW ch. 5.6)."""
    acc = torch.zeros_like(px)
    weight = 1.0
    for od in range(depth):
        sc = float(1 << od)
        acc = acc + weight * torch.abs(perlin_noise(px * sc, py * sc,
                                                    pz * sc))
        weight *= 0.5
    return acc


def marble(scale, p):
    """The marble's factor 0.5 (1 + sin(scale z + 10 turb(p))) (RTTNW
    ch. 5.7) at points p (3,N); scale (N,)."""
    return 0.5 * (1.0 + torch.sin(scale * p[2]
                                  + 10.0 * perlin_turb(p[0], p[1], p[2])))


def texel_index(images_shape, img_idx, u, v):
    """The flat texel of a nearest lookup (rrt_tpu's texture_value):
    x = int(clip(u) AW), y = int((1 - clip(v)) AH), each clipped to the
    grid, in image clip(img_idx, 0, I - 1). images_shape: (I, AH, AW);
    returns int64 (N,) into the (I * AH * AW) texels."""
    n_img, ah, aw = images_shape
    uc = torch.clamp(u, 0.0, 1.0)
    vc = 1.0 - torch.clamp(v, 0.0, 1.0)
    xi = torch.clamp((uc * aw).to(torch.int64), 0, aw - 1)
    yi = torch.clamp((vc * ah).to(torch.int64), 0, ah - 1)
    img = torch.clamp(img_idx.to(torch.int64), 0, n_img - 1)
    return (img * ah + yi) * aw + xi


def use_color2(scene: SceneArrays, tex_id, p):
    """(N,) bool: the checker's odd cells (RTTNW ch. 4.3 sine form),
    where the texture shows color2; False on other textures. A discrete
    decision, so it carries no gradient."""
    tex_id = tex_id.long()
    scale = scene.tex_scale[tex_id]
    s = (torch.sin(scale * p[0]) * torch.sin(scale * p[1])
         * torch.sin(scale * p[2]))
    return (scene.tex_type[tex_id] == TEX_CHECKER) & (s < 0.0)


def scene_texel(scene: SceneArrays, tex_id, u, v):
    """texel_index of each ray's image texture tex_id (N,) at (u, v);
    a texture without an image reads image 0."""
    tex_id = tex_id.long()
    return texel_index(tuple(scene.images.shape[:3]),
                       torch.clamp(scene.tex_image[tex_id], min=0), u, v)


def texture_value(scene: SceneArrays, tex_id, u, v, p):
    """Evaluate texture tex_id (N,) at surface uv and point p (3,N) ->
    (3,N). The marble and the image are evaluated only when the scene
    has them (its static flags)."""
    tex_id = tex_id.long()
    ttype = scene.tex_type[tex_id]
    c1 = scene.tex_color1[tex_id].T
    c2 = scene.tex_color2[tex_id].T
    out = torch.where(use_color2(scene, tex_id, p), c2, c1)
    if scene.has_perlin:
        out = torch.where(ttype == TEX_PERLIN,
                          marble(scene.tex_scale[tex_id], p) * c1, out)
    if scene.has_images:
        texel = scene_texel(scene, tex_id, u, v)
        image = scene.images.reshape(-1, 3)[texel].T
        out = torch.where(ttype == TEX_IMAGE, image, out)
    return torch.where(ttype == TEX_SOLID, c1, out)
