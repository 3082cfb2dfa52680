"""Scene representation: host-side builder -> structure-of-arrays tensors.

The scene compiles once on the host into structure-of-arrays tensors:
primitives are grouped into families (spheres, quads, boxes, constant
media), each padded to a multiple of 128 slots; materials and textures
are tables indexed by integer ids. The layout, padding and slot order
are the same as `rrt_tpu.scene`, so the port's arrays equal the JAX
package's element for element.

This port builds the sphere family (stationary and moving spheres), the
quad family, the box family (rrt_tpu's slab-test box, with its
rotation about the world Y axis baked into cos/sin) and the
constant-medium family (a sphere or an oriented box boundary, padded to
8 slots), with solid, checker, perlin-marble and image textures (the
images resampled onto one atlas grid, `resample_image`; a box whose
material carries an image is built as the books' six quads), the
lambertian, metal, dielectric, diffuse_light and isotropic materials
and either background.
"""

import dataclasses
import math

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

# Constant-medium boundary types (med_btype).
BOUND_SPHERE = 0
BOUND_OBB = 1

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


def resample_image(im: np.ndarray, ah: int, aw: int,
                   method: str = "nearest") -> np.ndarray:
    """Host-side (h,w,3) -> (ah,aw,3) resample onto the atlas grid
    (rrt_tpu.scene.resample_image, the same arithmetic): "nearest" keeps
    the texel values, "bilinear" smooths a photograph."""
    f32 = np.float32
    im = np.asarray(im, f32)
    h, w = im.shape[:2]
    if (h, w) == (ah, aw):
        return im
    if method == "bilinear":
        yf = (np.arange(ah, dtype=np.float64) + 0.5) * h / ah - 0.5
        xf = (np.arange(aw, dtype=np.float64) + 0.5) * w / aw - 0.5
        y0 = np.clip(np.floor(yf).astype(np.int64), 0, h - 1)
        x0 = np.clip(np.floor(xf).astype(np.int64), 0, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        ty = np.clip(yf - y0, 0.0, 1.0).astype(f32)[:, None, None]
        tx = np.clip(xf - x0, 0.0, 1.0).astype(f32)[None, :, None]
        top = (im[y0[:, None], x0[None, :]] * (1 - tx)
               + im[y0[:, None], x1[None, :]] * tx)
        bot = (im[y1[:, None], x0[None, :]] * (1 - tx)
               + im[y1[:, None], x1[None, :]] * tx)
        return top * (1 - ty) + bot * ty
    yi = (np.arange(ah) * h // ah).clip(0, h - 1)
    xi = (np.arange(aw) * w // aw).clip(0, w - 1)
    return im[yi[:, None], xi[None, :]]


def _rot_y(deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                    dtype=np.float32)


class SceneBuilder:
    """Host-side scene construction; `build()` freezes to SceneArrays.

    Same constructive surface and build layout as rrt_tpu.scene's
    builder for the families this port renders."""

    def __init__(self):
        self._spheres = []  # (c0, c1, t0, t1, radius, mat_id)
        self._quads = []  # (q, u, v, mat_id)
        self._boxes = []  # (center, half, cos, sin, mat_id)
        self._media = []  # (btype, center, radius, half, rot, -1/density, mat)
        self._materials = []  # (type, tex_id, fuzz, ior)
        self._textures = []  # (type, c1, c2, scale, image_idx)
        self._images = []  # ((h,w,3) float32 array, resample)
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
        """The marble of RTTNW ch. 5.7: color1 white, `scale` the sine's
        frequency along z."""
        return self._add_texture(TEX_PERLIN, c1=(1, 1, 1), scale=scale)

    def image(self, pixels, resample: str = "nearest") -> int:
        """pixels: (h,w,3) float in [0,1]; `resample` ("nearest" or
        "bilinear") fits it onto the atlas grid at build time when its
        size differs from the largest image's."""
        if resample not in ("nearest", "bilinear"):
            raise ValueError(f"resample must be nearest|bilinear, "
                             f"got {resample!r}")
        self._images.append((np.asarray(pixels, dtype=np.float32),
                             resample))
        return self._add_texture(TEX_IMAGE, image_idx=len(self._images) - 1)

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
        return self._add_material(MAT_DIFFUSE_LIGHT, self._as_tex(emit))

    def isotropic(self, albedo) -> int:
        return self._add_material(MAT_ISOTROPIC, self._as_tex(albedo))

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
        """Parallelogram with corner q and edges u, v; the instance
        transform is baked into the vertices, rotation about the world Y
        axis first, then translation (the books' translate(rotate_y(...)))."""
        q = np.asarray(q, np.float32)
        u = np.asarray(u, np.float32)
        v = np.asarray(v, np.float32)
        if rotate_y_deg:
            r = _rot_y(rotate_y_deg)
            q, u, v = r @ q, r @ u, r @ v
        q = q + np.asarray(translate, np.float32)
        self._quads.append((q, u, v, mat_id))

    def box(self, corner0, corner1, mat_id: int, rotate_y_deg: float = 0.0,
            translate=(0.0, 0.0, 0.0)):
        """Axis-aligned box [corner0, corner1], rotated about world Y and
        then translated, into the box family (one slab test); a box whose
        material carries an image texture becomes the books' six quads
        instead, so that its faces have their uv (RTTNW listing 6.2)."""
        if self._textures[self._materials[mat_id][1]][0] == TEX_IMAGE:
            self._box_as_quads(corner0, corner1, mat_id, rotate_y_deg,
                               translate)
            return
        a = np.minimum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        b = np.maximum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        r = math.radians(rotate_y_deg)
        c, s = np.float32(math.cos(r)), np.float32(math.sin(r))
        center = _rot_y(rotate_y_deg) @ (0.5 * (a + b)) \
            + np.asarray(translate, np.float32)
        self._boxes.append((center.astype(np.float32),
                            (0.5 * (b - a)).astype(np.float32), c, s,
                            mat_id))

    def _box_as_quads(self, corner0, corner1, mat_id, rotate_y_deg,
                      translate):
        """The six faces of the box [corner0, corner1] as quads, in
        rrt_tpu's order and corners (front, right, left, back, top,
        bottom)."""
        a = np.minimum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        b = np.maximum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        dx = np.array([b[0] - a[0], 0, 0], np.float32)
        dy = np.array([0, b[1] - a[1], 0], np.float32)
        dz = np.array([0, 0, b[2] - a[2]], np.float32)
        faces = [
            (np.array([a[0], a[1], b[2]], np.float32), dx, dy),
            (np.array([b[0], a[1], b[2]], np.float32), -dz, dy),
            (np.array([a[0], a[1], a[2]], np.float32), dz, dy),
            (np.array([b[0], a[1], a[2]], np.float32), -dx, dy),
            (np.array([a[0], b[1], b[2]], np.float32), dx, -dz),
            (np.array([a[0], a[1], a[2]], np.float32), dx, dz),
        ]
        for q, u, v in faces:
            self.quad(q, u, v, mat_id, rotate_y_deg=rotate_y_deg,
                      translate=translate)

    def medium_sphere(self, center, radius: float, density: float,
                      albedo) -> None:
        """A constant medium (RTTNW ch. 9) inside a sphere boundary, with
        an isotropic material of `albedo`."""
        mat = self.isotropic(albedo)
        self._media.append((BOUND_SPHERE, np.asarray(center, np.float32),
                            float(radius), np.zeros(3, np.float32),
                            np.eye(3, dtype=np.float32),
                            -1.0 / float(density), mat))

    def medium_box(self, corner0, corner1, density: float, albedo,
                   rotate_y_deg: float = 0.0,
                   translate=(0.0, 0.0, 0.0)) -> None:
        """A constant medium inside the box [corner0, corner1], rotated
        about world Y and then translated: an oriented box boundary whose
        world-from-box rotation is kept as a matrix (med_rot)."""
        a = np.minimum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        b = np.maximum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        center = 0.5 * (a + b)
        half = 0.5 * (b - a)
        rot = _rot_y(rotate_y_deg) if rotate_y_deg else np.eye(
            3, dtype=np.float32)
        center = rot @ center + np.asarray(translate, np.float32)
        mat = self.isotropic(albedo)
        self._media.append((BOUND_OBB, center, 0.0, half, rot,
                            -1.0 / float(density), mat))

    # -- background -------------------------------------------------------

    def sky(self, bottom=(1.0, 1.0, 1.0), top=(0.5, 0.7, 1.0)):
        self.bg_mode = BG_SKY
        self.bg_bottom, self.bg_top = tuple(bottom), tuple(top)

    def solid_background(self, color=(0.0, 0.0, 0.0)):
        self.bg_mode = BG_SOLID
        self.bg_bottom = self.bg_top = tuple(color)

    # -- freeze -----------------------------------------------------------

    @staticmethod
    def _morton_perm(centers: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """rrt_tpu.scene.SceneBuilder._morton_perm: the permutation that
        puts the valid slots in Morton (Z-curve) order of their centers,
        each axis quantized to 10 bits over the valid centers' range, the
        invalid slots last (a stable sort, so equal codes keep their
        order)."""
        n = centers.shape[0]
        if valid.sum() <= 1:
            return np.arange(n)
        c = centers[valid]
        lo, hi = c.min(0), c.max(0)
        q = np.clip((c - lo) / np.maximum(hi - lo, 1e-20) * 1023.0,
                    0.0, 1023.0).astype(np.uint64)
        code = np.zeros(len(c), np.uint64)
        for b in range(10):
            for a in range(3):
                code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) \
                    << np.uint64(3 * b + a)
        return np.concatenate([
            np.flatnonzero(valid)[np.argsort(code, kind="stable")],
            np.flatnonzero(~valid)])

    def build(self, spatial_sort: bool = False) -> SceneArrays:
        """Freeze to SceneArrays on the CPU. spatial_sort: the sphere,
        quad and box families' slots in Morton order of their centers
        (_morton_perm), as rrt_tpu's build(spatial_sort=True) lays out
        the RTTNW final scene; the valid slots stay first."""
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
        nq = _pad_to(len(self._quads))
        quad_q = np.zeros((nq, 3), f32)
        quad_u = np.tile(np.array([1, 0, 0], f32), (nq, 1))
        quad_v = np.tile(np.array([0, 1, 0], f32), (nq, 1))
        quad_mat = np.zeros((nq,), i32)
        quad_valid = np.zeros((nq,), bool)
        for i, (q, u, v, m) in enumerate(self._quads):
            quad_q[i], quad_u[i], quad_v[i] = q, u, v
            quad_mat[i] = m
            quad_valid[i] = True

        nb = _pad_to(len(self._boxes))
        box_center = np.zeros((nb, 3), f32)
        box_half = np.zeros((nb, 3), f32)
        box_cos = np.ones((nb,), f32)
        box_sin = np.zeros((nb,), f32)
        box_mat = np.zeros((nb,), i32)
        box_valid = np.zeros((nb,), bool)
        for i, (c, h, cth, sth, m) in enumerate(self._boxes):
            box_center[i], box_half[i] = c, h
            box_cos[i], box_sin[i] = cth, sth
            box_mat[i] = m
            box_valid[i] = True

        if spatial_sort:
            ps = self._morton_perm(sphere_c0 + 0.5 * sphere_dc,
                                   sphere_valid)
            sphere_c0, sphere_dc = sphere_c0[ps], sphere_dc[ps]
            sphere_t0, sphere_inv_dt = sphere_t0[ps], sphere_inv_dt[ps]
            sphere_radius, sphere_mat = sphere_radius[ps], sphere_mat[ps]
            sphere_valid = sphere_valid[ps]
            pq = self._morton_perm(quad_q + 0.5 * (quad_u + quad_v),
                                   quad_valid)
            quad_q, quad_u, quad_v = quad_q[pq], quad_u[pq], quad_v[pq]
            quad_mat, quad_valid = quad_mat[pq], quad_valid[pq]
            pb = self._morton_perm(box_center, box_valid)
            box_center, box_half = box_center[pb], box_half[pb]
            box_cos, box_sin = box_cos[pb], box_sin[pb]
            box_mat, box_valid = box_mat[pb], box_valid[pb]

        nd = _pad_to(len(self._media), lane=8)
        med_btype = np.zeros((nd,), i32)
        med_center = np.zeros((nd, 3), f32)
        med_radius = np.ones((nd,), f32)
        med_half = np.ones((nd, 3), f32)
        med_rot = np.tile(np.eye(3, dtype=f32), (nd, 1, 1))
        med_nid = np.full((nd,), -1.0, f32)
        med_mat = np.zeros((nd,), i32)
        med_valid = np.zeros((nd,), bool)
        for i, (bt, c, r, h, rot, nidv, m) in enumerate(self._media):
            med_btype[i], med_center[i], med_radius[i] = bt, c, r
            med_half[i], med_rot[i], med_nid[i], med_mat[i] = h, rot, nidv, m
            med_valid[i] = True

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

        if self._images:
            # One atlas grid, the largest image's: a lookup needs no
            # per-image shape.
            ah = max(im.shape[0] for im, _ in self._images)
            aw = max(im.shape[1] for im, _ in self._images)
            images = np.zeros((len(self._images), ah, aw, 3), f32)
            for i, (im, resample) in enumerate(self._images):
                images[i] = resample_image(im, ah, aw, resample)
        else:
            images = np.zeros((1, 1, 1, 3), f32)
        img_tex = set(np.nonzero(tex_type == TEX_IMAGE)[0].tolist())

        t = torch.from_numpy
        return SceneArrays(
            sphere_c0=t(sphere_c0), sphere_dc=t(sphere_dc),
            sphere_t0=t(sphere_t0), sphere_inv_dt=t(sphere_inv_dt),
            sphere_radius=t(sphere_radius), sphere_mat=t(sphere_mat),
            sphere_valid=t(sphere_valid),
            quad_q=t(quad_q), quad_u=t(quad_u), quad_v=t(quad_v),
            quad_mat=t(quad_mat), quad_valid=t(quad_valid),
            box_center=t(box_center), box_half=t(box_half),
            box_cos=t(box_cos), box_sin=t(box_sin), box_mat=t(box_mat),
            box_valid=t(box_valid),
            med_btype=t(med_btype), med_center=t(med_center),
            med_radius=t(med_radius), med_half=t(med_half),
            med_rot=t(med_rot), med_neg_inv_density=t(med_nid),
            med_mat=t(med_mat), med_valid=t(med_valid),
            mat_type=t(mat_type), mat_tex=t(mat_tex),
            mat_fuzz=t(mat_fuzz), mat_ior=t(mat_ior),
            tex_type=t(tex_type), tex_color1=t(tex_color1),
            tex_color2=t(tex_color2), tex_scale=t(tex_scale),
            tex_image=t(tex_image),
            images=t(images),
            bg_mode=torch.tensor(self.bg_mode, dtype=torch.int32),
            bg_bottom=torch.tensor(self.bg_bottom, dtype=torch.float32),
            bg_top=torch.tensor(self.bg_top, dtype=torch.float32),
            has_quads=bool(self._quads),
            has_boxes=bool(self._boxes),
            has_rot_boxes=any(abs(float(b[3])) > 0.0 for b in self._boxes),
            has_media=bool(self._media),
            has_perlin=bool((tex_type == TEX_PERLIN).any()),
            has_images=bool(self._images),
            has_emissive=bool((mat_type == MAT_DIFFUSE_LIGHT).any()),
            has_moving=bool(np.abs(sphere_dc).max() > 0.0)
            if len(self._spheres) else False,
            has_images_on_media=any(
                self._materials[int(m)][1] in img_tex
                for m in med_mat[med_valid]),
            n_media_active=len(self._media),
            n_spheres_active=len(self._spheres),
            n_quads_active=len(self._quads),
            n_boxes_active=len(self._boxes),
        )
