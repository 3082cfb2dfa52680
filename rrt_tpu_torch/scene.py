"""Scene representation: host-side builder -> structure-of-arrays tensors.

The scene compiles once on the host into structure-of-arrays tensors:
primitives are grouped into families (spheres, quads, boxes, constant
media), each padded to a multiple of 128 slots; materials and textures
are tables indexed by integer ids. The layout, padding and slot order
are the same as `rrt_tpu.scene`, so the port's arrays equal the JAX
package's element for element.

This port builds the sphere family (stationary and moving spheres) with
solid and checker textures, the lambertian, metal and dielectric
materials and either background.
The other builders raise NotImplementedError naming the ROADMAP item
that ports them; their families stay at the empty padded layout.
"""

import dataclasses

import numpy as np
import torch

# Material type ids.
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

# Texture type ids.
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_PERLIN = 2
TEX_IMAGE = 3

# Background modes.
BG_SKY = 0  # vertical lerp between bg_bottom and bg_top (the RTIOW sky)
BG_SOLID = 1  # constant bg_bottom

_LANE = 128  # families pad to multiples of 128 slots, as in rrt_tpu


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Scene tensors, one field per `rrt_tpu.scene.SceneArrays` leaf, plus
    the same static capability flags and active counts."""

    # Sphere family (dc == 0 for stationary spheres).
    sphere_c0: torch.Tensor  # (S,3) center at time0
    sphere_dc: torch.Tensor  # (S,3) center1 - center0
    sphere_t0: torch.Tensor  # (S,)
    sphere_inv_dt: torch.Tensor  # (S,) 1/(time1-time0)
    sphere_radius: torch.Tensor  # (S,) may be negative (hollow glass)
    sphere_mat: torch.Tensor  # (S,) i32
    sphere_valid: torch.Tensor  # (S,) bool

    # Quad family (parallelograms: point Q, edge vectors u, v).
    quad_q: torch.Tensor  # (Q,3)
    quad_u: torch.Tensor  # (Q,3)
    quad_v: torch.Tensor  # (Q,3)
    quad_mat: torch.Tensor  # (Q,) i32
    quad_valid: torch.Tensor  # (Q,) bool

    # Box family (axis-aligned box with a baked world-Y rotation).
    box_center: torch.Tensor  # (B,3)
    box_half: torch.Tensor  # (B,3)
    box_cos: torch.Tensor  # (B,)
    box_sin: torch.Tensor  # (B,)
    box_mat: torch.Tensor  # (B,) i32
    box_valid: torch.Tensor  # (B,) bool

    # Constant-medium family.
    med_btype: torch.Tensor  # (D,) i32 boundary type (sphere 0, box 1)
    med_center: torch.Tensor  # (D,3)
    med_radius: torch.Tensor  # (D,)
    med_half: torch.Tensor  # (D,3)
    med_rot: torch.Tensor  # (D,3,3) world-from-box rotation
    med_neg_inv_density: torch.Tensor  # (D,)
    med_mat: torch.Tensor  # (D,) i32
    med_valid: torch.Tensor  # (D,) bool

    # Material table.
    mat_type: torch.Tensor  # (K,) i32
    mat_tex: torch.Tensor  # (K,) i32 texture id
    mat_fuzz: torch.Tensor  # (K,)
    mat_ior: torch.Tensor  # (K,)

    # Texture table.
    tex_type: torch.Tensor  # (T,) i32
    tex_color1: torch.Tensor  # (T,3)
    tex_color2: torch.Tensor  # (T,3)
    tex_scale: torch.Tensor  # (T,)
    tex_image: torch.Tensor  # (T,) i32 index into the image atlas

    images: torch.Tensor  # (I,AH,AW,3) image atlas

    # Background.
    bg_mode: torch.Tensor  # () i32
    bg_bottom: torch.Tensor  # (3,)
    bg_top: torch.Tensor  # (3,)

    # Static capability flags and true (unpadded) family counts.
    has_quads: bool = False
    has_boxes: bool = False
    has_rot_boxes: bool = False
    has_media: bool = False
    has_perlin: bool = False
    has_images: bool = False
    has_emissive: bool = False
    has_moving: bool = False
    has_images_on_media: bool = False
    n_media_active: int = 0
    n_spheres_active: int = 0
    n_quads_active: int = 0
    n_boxes_active: int = 0

    @property
    def n_spheres(self) -> int:
        return self.sphere_radius.shape[0]

    def to(self, device) -> "SceneArrays":
        """The same scene with every tensor on `device` (differentiable,
        like Tensor.to)."""
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device) for name in tensor_fields()})


def tensor_fields():
    """Names of the SceneArrays fields that hold tensors."""
    return [f.name for f in dataclasses.fields(SceneArrays)
            if f.type is torch.Tensor]


def _pad_to(n: int, lane: int = _LANE) -> int:
    return max(lane, ((n + lane - 1) // lane) * lane)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to rrt_tpu_torch yet (ROADMAP Queue A "
        f"{item})")


class SceneBuilder:
    """Host-side scene construction; `build()` freezes to SceneArrays.

    Same constructive surface and build layout as rrt_tpu.scene's
    builder for the families this port renders."""

    def __init__(self):
        self._spheres = []  # (c0, c1, t0, t1, radius, mat_id)
        self._materials = []  # (type, tex_id, fuzz, ior)
        self._textures = []  # (type, c1, c2, scale, image_idx)
        self.bg_mode = BG_SKY
        self.bg_bottom = (1.0, 1.0, 1.0)
        self.bg_top = (0.5, 0.7, 1.0)

    # -- textures ---------------------------------------------------------

    def _add_texture(self, ttype, c1=(0, 0, 0), c2=(0, 0, 0), scale=0.0,
                     image_idx=-1) -> int:
        self._textures.append((ttype, tuple(map(float, c1)),
                               tuple(map(float, c2)), float(scale),
                               int(image_idx)))
        return len(self._textures) - 1

    def solid(self, color) -> int:
        return self._add_texture(TEX_SOLID, c1=color)

    def checker(self, even, odd, scale: float = 10.0) -> int:
        return self._add_texture(TEX_CHECKER, c1=even, c2=odd, scale=scale)

    def perlin(self, scale: float = 1.0) -> int:
        _not_ported("the perlin texture", "#9.5")

    def image(self, pixels, resample: str = "nearest") -> int:
        _not_ported("the image texture", "#9.5")

    def _as_tex(self, color_or_tex) -> int:
        if isinstance(color_or_tex, int):
            return color_or_tex
        return self.solid(color_or_tex)

    # -- materials --------------------------------------------------------

    def _add_material(self, mtype, tex_id, fuzz=0.0, ior=1.0) -> int:
        self._materials.append((mtype, tex_id, float(fuzz), float(ior)))
        return len(self._materials) - 1

    def lambertian(self, albedo) -> int:
        return self._add_material(MAT_LAMBERTIAN, self._as_tex(albedo))

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        return self._add_material(MAT_METAL, self._as_tex(albedo), fuzz=fuzz)

    def dielectric(self, ior: float) -> int:
        return self._add_material(MAT_DIELECTRIC, self.solid((1, 1, 1)),
                                  ior=ior)

    def diffuse_light(self, emit) -> int:
        _not_ported("the diffuse_light material", "#9.2")

    def isotropic(self, albedo) -> int:
        _not_ported("the isotropic material", "#9.4")

    # -- primitives -------------------------------------------------------

    def sphere(self, center, radius: float, mat_id: int):
        self._spheres.append((np.asarray(center, np.float32),
                              np.asarray(center, np.float32), 0.0, 1.0,
                              float(radius), mat_id))

    def moving_sphere(self, center0, center1, time0: float, time1: float,
                      radius: float, mat_id: int):
        self._spheres.append((np.asarray(center0, np.float32),
                              np.asarray(center1, np.float32), float(time0),
                              float(time1), float(radius), mat_id))

    def quad(self, q, u, v, mat_id: int, rotate_y_deg: float = 0.0,
             translate=(0.0, 0.0, 0.0)):
        _not_ported("the quad family", "#9.2")

    def box(self, corner0, corner1, mat_id: int, rotate_y_deg: float = 0.0,
            translate=(0.0, 0.0, 0.0)):
        _not_ported("the box family", "#9.3")

    def medium_sphere(self, center, radius: float, density: float,
                      albedo) -> None:
        _not_ported("the constant medium", "#9.4")

    def medium_box(self, corner0, corner1, density: float, albedo,
                   rotate_y_deg: float = 0.0,
                   translate=(0.0, 0.0, 0.0)) -> None:
        _not_ported("the constant medium", "#9.4")

    # -- background -------------------------------------------------------

    def sky(self, bottom=(1.0, 1.0, 1.0), top=(0.5, 0.7, 1.0)):
        self.bg_mode = BG_SKY
        self.bg_bottom, self.bg_top = tuple(bottom), tuple(top)

    def solid_background(self, color=(0.0, 0.0, 0.0)):
        self.bg_mode = BG_SOLID
        self.bg_bottom = self.bg_top = tuple(color)

    # -- freeze -----------------------------------------------------------

    def build(self) -> SceneArrays:
        """Freeze to SceneArrays on the CPU. (rrt_tpu's
        build(spatial_sort=True) comes with its only user, the RTTNW
        final scene: ROADMAP Queue A #9.5.)"""
        f32, i32 = np.float32, np.int32

        ns = _pad_to(len(self._spheres))
        sphere_c0 = np.zeros((ns, 3), f32)
        sphere_dc = np.zeros((ns, 3), f32)
        sphere_t0 = np.zeros((ns,), f32)
        sphere_inv_dt = np.ones((ns,), f32)
        sphere_radius = np.full((ns,), 1.0, f32)
        sphere_mat = np.zeros((ns,), i32)
        sphere_valid = np.zeros((ns,), bool)
        for i, (c0, c1, t0, t1, r, m) in enumerate(self._spheres):
            sphere_c0[i] = c0
            sphere_dc[i] = c1 - c0
            sphere_t0[i] = t0
            sphere_inv_dt[i] = 1.0 / (t1 - t0) if t1 != t0 else 0.0
            sphere_radius[i] = r
            sphere_mat[i] = m
            sphere_valid[i] = True
        # Empty quad / box / medium families at rrt_tpu's padded layout.
        nq = _pad_to(0)
        nb = _pad_to(0)
        nd = _pad_to(0, lane=8)

        if not self._materials:
            self._add_material(MAT_LAMBERTIAN, self.solid((0.5, 0.5, 0.5)))
        mat_type = np.array([m[0] for m in self._materials], i32)
        mat_tex = np.array([m[1] for m in self._materials], i32)
        mat_fuzz = np.array([m[2] for m in self._materials], f32)
        mat_ior = np.array([m[3] for m in self._materials], f32)

        nt = len(self._textures)
        tex_type = np.array([t[0] for t in self._textures], i32)
        tex_color1 = np.array([t[1] for t in self._textures], f32).reshape(
            nt, 3)
        tex_color2 = np.array([t[2] for t in self._textures], f32).reshape(
            nt, 3)
        tex_scale = np.array([t[3] for t in self._textures], f32)
        tex_image = np.array([t[4] for t in self._textures], i32)

        t = torch.from_numpy
        return SceneArrays(
            sphere_c0=t(sphere_c0), sphere_dc=t(sphere_dc),
            sphere_t0=t(sphere_t0), sphere_inv_dt=t(sphere_inv_dt),
            sphere_radius=t(sphere_radius), sphere_mat=t(sphere_mat),
            sphere_valid=t(sphere_valid),
            quad_q=torch.zeros((nq, 3)),
            quad_u=torch.tensor([1.0, 0.0, 0.0]).repeat(nq, 1),
            quad_v=torch.tensor([0.0, 1.0, 0.0]).repeat(nq, 1),
            quad_mat=torch.zeros((nq,), dtype=torch.int32),
            quad_valid=torch.zeros((nq,), dtype=torch.bool),
            box_center=torch.zeros((nb, 3)), box_half=torch.zeros((nb, 3)),
            box_cos=torch.ones((nb,)), box_sin=torch.zeros((nb,)),
            box_mat=torch.zeros((nb,), dtype=torch.int32),
            box_valid=torch.zeros((nb,), dtype=torch.bool),
            med_btype=torch.zeros((nd,), dtype=torch.int32),
            med_center=torch.zeros((nd, 3)), med_radius=torch.ones((nd,)),
            med_half=torch.ones((nd, 3)),
            med_rot=torch.eye(3).repeat(nd, 1, 1),
            med_neg_inv_density=torch.full((nd,), -1.0),
            med_mat=torch.zeros((nd,), dtype=torch.int32),
            med_valid=torch.zeros((nd,), dtype=torch.bool),
            mat_type=t(mat_type), mat_tex=t(mat_tex),
            mat_fuzz=t(mat_fuzz), mat_ior=t(mat_ior),
            tex_type=t(tex_type), tex_color1=t(tex_color1),
            tex_color2=t(tex_color2), tex_scale=t(tex_scale),
            tex_image=t(tex_image),
            images=torch.zeros((1, 1, 1, 3)),
            bg_mode=torch.tensor(self.bg_mode, dtype=torch.int32),
            bg_bottom=torch.tensor(self.bg_bottom, dtype=torch.float32),
            bg_top=torch.tensor(self.bg_top, dtype=torch.float32),
            has_perlin=bool((tex_type == TEX_PERLIN).any()),
            has_emissive=bool((mat_type == MAT_DIFFUSE_LIGHT).any()),
            has_moving=bool(np.abs(sphere_dc).max() > 0.0)
            if len(self._spheres) else False,
            n_spheres_active=len(self._spheres),
        )
