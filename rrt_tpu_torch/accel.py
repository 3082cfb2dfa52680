"""The closest-sphere BVH of the tile_render and intersect_only kernels:
the host-side builder, the kernels' packed layout, and a plain walk
over that layout; and the trees of the quad and box families, which the
forward kernels walk past SOLID_CAP active slots (`pack_solid_bvh`,
`solid_closest_reference`; their rule below the spheres').

`build_sphere_bvh` / `build_bvh` are rrt_tpu/accel.py's builder in
numpy (its copy here: that module imports JAX): the reference's Middle
split (src/acceleration.rs:96-273) with the per-split EqualCount
fallback on a degenerate split and leaves of up to LEAF_SIZE = 4
primitives. Nodes come out in preorder, so an inner node's left child
is the next node.

`pack_bvh` builds the tree the kernels walk (ops/csrc/bounce.cuh,
closest_sphere_bvh) over a sphere pack and lays it out for them. The
walk must give the linear scan's (t, winner) bit for bit, so a node may
be skipped only when no slot inside it can produce a root below the
current best under the kernels' own arithmetic (the expanded quadratic
of bounce.cuh, built with -fmad=false), which cancels badly far from
the origin. The rule:

  * The computed root t of a slot with center c and radius r on a ray
    (o, d) is an exact root of a perturbed quadratic: the point o + t d
    lies at most sqrt(r^2 + E) from c, with E <= K u S^2, where u =
    2^-24, S = |o| + |c| + r and K = 51 from the operation count of
    quadratic() and nearest_root() (half_b, c_coef, the discriminant,
    the root formula). K = 128 is used. Since S^2 <= 2 (|c| + r)^2 + 2
    |o|^2, that distance is at most R + p |o| with R = sqrt(r^2 + 2 K u
    (|c| + r)^2) per slot and p = sqrt(2 K u) = 2^-8 per ray. A slot's
    box is its center's range padded by R (and by the rounding of a
    moving center, 4 u (|base| + |time| |vel|)), rounded outward to
    float32; the walk pads every box by RAY_PAD times the ray origin's
    L1 norm (>= its length) at test time.
  * The slab test keeps rrt_tpu's far pad 1 + 2 gamma(3)
    (rrt_tpu/utils/fp.py), which covers its own rounding, and skips a
    node only when its near distance exceeds the best t found so far
    (times that pad): a slot tied with the best is still reached, and
    ties go to the lower slot, the scan's first minimum.
  * A slot whose box's longest side is ALWAYS_SIDE (8) times the median
    of the valid slots' or more is tested by every segment before the
    walk, in slot order, and is left out of the tree: chap12's
    radius-1000 ground sphere, which a ray leaving its surface re-hits
    anywhere, and whose box would make the tree's top one box.
  * Invalid slots (r^2 = -1) never hit and are left out.

Moving spheres are bounded over their swept center base + time * vel
for time over the rays' shutter [time0, time1], widened by its float32
rounding: the camera pack's rows 19-20 for tile_render; for
intersect_only the camera that made the rays (render.render_tile), or
the rays' own times (render.trace_batch without packs). So the kernel
never reads a ray's time to decide a box, and needs no host sync per
call.

Layout (`BvhPack`): `nodes` (M, 8) float32, two float4 a node: lo.xyz
and w0, hi.xyz and w1, where w0 and w1 hold int32 bits. An inner node
has w1 = -1 - split axis and w0 = its right child (the left is the next
node); a leaf has w1 = its count (1-4) and w0 = its first row. `rows`
(A + P,) int32: the original slot of each row the kernel stages, the A
always-tested slots first, then each leaf's slots as a contiguous run.

`bvh_closest_reference` walks the packed layout in plain PyTorch with
intersect_only_reference's arithmetic, counting its node and slot tests
(for tests, and for chip_smoke.py's bound of the walk). Seeded by the t
of another family (the quads and boxes, which the kernels test first),
the walk keeps it unless a sphere beats it strictly, as the seeded scan
does. `pack_scan` is the pack whose walk is that scan: every valid slot
tested in slot order, no tree; the kernels walking it give the scan's
(t, winner), which the walk over the tree must equal bit for bit.
"""

import dataclasses

import numpy as np
import torch

LEAF_SIZE = 4
# The kernels' per-thread stack (bounce.cuh kBvhStack): a tree whose
# deepest leaf lies further below the root raises.
BVH_STACK = 32
# Shared memory a block of the walking kernels opts into, less 1 KB for
# their static arrays (the camera and background packs): 227 KB on an
# H100.
BVH_SMEM = 227 * 1024 - 1024
# The error model's constants (module docstring).
_U = 2.0 ** -24
_K = 128.0
RAY_PAD = 2.0 ** -8  # sqrt(2 K u), bounce.cuh kRayPad
ALWAYS_SIDE = 8.0


@dataclasses.dataclass(frozen=True)
class BvhArrays:
    """A flattened BVH (rrt_tpu.accel.BvhArrays in numpy). Inner node:
    children in left/right, empty primitive run. Leaf: left == -1,
    primitives prim_order[prim_start:prim_start + prim_count]."""

    node_min: np.ndarray  # (M,3) f32
    node_max: np.ndarray  # (M,3) f32
    left: np.ndarray  # (M,) i32, -1 for a leaf
    right: np.ndarray  # (M,) i32
    axis: np.ndarray  # (M,) i32 split axis
    prim_start: np.ndarray  # (M,) i32 into prim_order
    prim_count: np.ndarray  # (M,) i32
    prim_order: np.ndarray  # (P,) i32 primitive ids, leaf-contiguous

    @property
    def n_nodes(self) -> int:
        return self.left.shape[0]


def build_sphere_bvh(scene) -> BvhArrays:
    """rrt_tpu.accel.build_sphere_bvh: the tree over the scene's valid
    spheres, each bounded by the union of its endpoint boxes (the
    reference's src/sphere.rs:25-35)."""
    c0 = scene.sphere_c0.detach().cpu().numpy()
    dc = scene.sphere_dc.detach().cpu().numpy()
    r = np.abs(scene.sphere_radius.detach().cpu().numpy())
    valid = scene.sphere_valid.cpu().numpy()
    ids = np.nonzero(valid)[0].astype(np.int32)
    lo = np.minimum(c0[ids] - r[ids, None], c0[ids] + dc[ids] - r[ids, None])
    hi = np.maximum(c0[ids] + r[ids, None], c0[ids] + dc[ids] + r[ids, None])
    return build_bvh(lo, hi, ids)


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray,
              prim_ids: np.ndarray) -> BvhArrays:
    """rrt_tpu.accel.build_bvh over primitive boxes, its default Middle
    method (host numpy, once per pack).

    rrt_tpu recurses node by node; this builds the same tree a level at
    a time, every node of a level in one pass of array operations (the
    render and the differentiable chain build a pack a call, where the
    recursion's small numpy calls cost milliseconds). A node's
    primitives are a run of `perm`; an inner node's run is split in
    place, stably, into its left child's run and its right child's, so
    each level's runs keep the recursion's order, and the leaves' runs
    end up in preorder: `perm` is then the recursion's prim_order and a
    leaf's run start its prim_start. Nodes are numbered in preorder at
    the end."""
    centroid = 0.5 * (prim_min + prim_max)
    boxes = np.concatenate([prim_min, prim_max, centroid], axis=1)
    perm = np.arange(len(prim_ids))
    # Each level's nodes, in the order they are made: boxes, split axis
    # (0 on a leaf), a leaf's run, the made ids of an inner node's
    # children (-1 on a leaf).
    levels = []
    starts, sizes = np.zeros(1, np.int64), np.array([len(prim_ids)])
    n_made = 0
    while starts.size:
        k = starts.size
        offs = np.cumsum(sizes) - sizes  # each run's first compact slot
        seg = np.repeat(np.arange(k), sizes)  # each element's run
        pos = np.repeat(starts - offs, sizes) + np.arange(sizes.sum())
        el = perm[pos]
        box = boxes[el]  # min xyz, max xyz, centroid xyz
        lo = np.minimum.reduceat(box, offs, axis=0)
        hi = np.maximum.reduceat(box, offs, axis=0)
        axis = np.argmax(hi[:, 6:] - lo[:, 6:], axis=1)
        rows = np.arange(k)
        mid = 0.5 * (lo[rows, 6 + axis] + hi[rows, 6 + axis])
        key = box[np.arange(el.size), 6 + axis[seg]]
        mask = key < mid[seg]
        n_left = np.add.reduceat(mask.astype(np.int64), offs)
        inner = sizes > LEAF_SIZE
        # A degenerate split: the per-split EqualCount fallback, half of
        # the run in stable order of the centroids on the axis.
        even = inner & ((n_left == 0) | (n_left == sizes))
        n_left = np.where(even, sizes // 2, n_left)
        rank = np.where(even[seg], key, (~mask).astype(np.float32))
        rank = np.where(inner[seg], rank, 0.0)
        perm[pos] = el[np.lexsort((np.arange(el.size), rank, seg))]
        kid = np.full((k, 2), -1, np.int64)
        kid[inner] = n_made + k + np.arange(2 * int(inner.sum())).reshape(
            -1, 2)
        levels.append((lo[:, 0:3], hi[:, 3:6],
                       np.where(inner, axis, 0), np.where(inner, 0, starts),
                       np.where(inner, 0, sizes), kid))
        n_made += k
        starts = np.stack([starts[inner], starts[inner] + n_left[inner]],
                          axis=1).ravel()
        sizes = np.stack([n_left[inner], sizes[inner] - n_left[inner]],
                         axis=1).ravel()
    lo, hi, axis, start, count, kid = (np.concatenate(f)
                                       for f in zip(*levels))
    # Preorder: a node, its left subtree, then its right subtree.
    order, stack, kids = [], [0], kid.tolist()
    while stack:
        i = stack.pop()
        order.append(i)
        if kids[i][0] >= 0:
            stack += [kids[i][1], kids[i][0]]
    pre = np.empty(len(order), np.int64)
    pre[order] = np.arange(len(order))
    kid = np.where(kid >= 0, pre[kid], -1)[order]
    i32 = np.int32
    return BvhArrays(
        node_min=lo[order].astype(np.float32),
        node_max=hi[order].astype(np.float32),
        left=kid[:, 0].astype(i32), right=kid[:, 1].astype(i32),
        axis=axis[order].astype(i32), prim_start=start[order].astype(i32),
        prim_count=count[order].astype(i32),
        prim_order=np.asarray(prim_ids[perm], i32))


@dataclasses.dataclass(frozen=True)
class BvhPack:
    """The kernels' BVH of one sphere pack (layout in the module
    docstring), on the device of its tensors."""

    nodes: torch.Tensor  # (M, 8) f32
    rows: torch.Tensor  # (A + P,) i32 slot of each staged row
    n_always: int  # A
    depth: int  # edges from the root to the deepest leaf
    n_slots: int  # the sphere pack's S
    shutter: tuple  # (time0, time1) the boxes cover

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_rows(self) -> int:
        return self.rows.shape[0]

    def smem_bytes(self, moving: bool) -> int:
        """The kernels' dynamic shared memory: two float4 a node, and a
        row's center and r^2 (float4), its velocity (float4, moving) or
        its staged |c|^2 (float, static), and its slot (int)."""
        return 32 * self.n_nodes + self.n_rows * (
            16 + (16 if moving else 4) + 4)

    def to(self, device) -> "BvhPack":
        return dataclasses.replace(self, nodes=self.nodes.to(device),
                                   rows=self.rows.to(device))


def _outward(x64: np.ndarray, down: bool) -> np.ndarray:
    """float64 bounds to float32, rounded away from the box's inside."""
    x32 = x64.astype(np.float32)
    if down:
        bad = x32.astype(np.float64) > x64
        x32[bad] = np.nextafter(x32[bad], np.float32(-np.inf))
    else:
        bad = x32.astype(np.float64) < x64
        x32[bad] = np.nextafter(x32[bad], np.float32(np.inf))
    return x32


def slot_boxes(sph24, shutter=None):
    """Every slot's conservative box (module docstring) over the sphere
    pack (24, S): (lo (S,3) f32, hi (S,3) f32, valid (S,) bool). shutter:
    (time0, time1) of the rays, required when a slot moves."""
    p = sph24.detach().cpu().to(torch.float64).numpy()
    valid = (p[7] > 0.5) & (p[3] >= 0.0)
    base, vel = p[0:3].T, p[4:7].T
    moving = np.any(vel[valid] != 0.0)
    if moving and shutter is None:
        raise ValueError("a pack with moving spheres needs the rays' "
                         "shutter (time0, time1)")
    t_lo, t_hi = (0.0, 0.0) if shutter is None else sorted(
        float(t) for t in shutter)
    eps = 4.0 * _U * (abs(t_lo) + abs(t_hi))  # the rays' times' rounding
    t_lo, t_hi = t_lo - eps, t_hi + eps
    c_lo = base + np.minimum(t_lo * vel, t_hi * vel)
    c_hi = base + np.maximum(t_lo * vel, t_hi * vel)
    t_abs = max(abs(t_lo), abs(t_hi))
    c_err = 4.0 * _U * (np.abs(base) + t_abs * np.abs(vel))
    c_mag = np.linalg.norm(np.maximum(np.abs(c_lo), np.abs(c_hi)),
                           axis=1) + np.linalg.norm(c_err, axis=1)
    r = np.maximum(np.sqrt(np.maximum(p[3], 0.0)), np.abs(p[18]))
    big_r = np.sqrt(r * r + 2.0 * _K * _U * (c_mag + r) ** 2)
    pad = big_r[:, None] + c_err
    return (_outward(c_lo - pad, True), _outward(c_hi + pad, False), valid)


def pack_bvh(sph24, shutter=None) -> BvhPack:
    """The kernels' BVH over the sphere pack sph24 (24, S), on sph24's
    device. shutter: (time0, time1) of the rays the kernel will test,
    floats or 0-d tensors (required when a slot moves: see the module
    docstring). Raises ValueError when the tree is deeper than the
    kernels' stack (BVH_STACK) or when the nodes and staged rows pass
    the shared memory they opt into (BVH_SMEM)."""
    if shutter is not None:
        shutter = tuple(float(t) for t in shutter)
    lo, hi, valid = slot_boxes(sph24, shutter)
    ids = np.nonzero(valid)[0].astype(np.int32)
    side = (hi - lo).max(axis=1)
    always = np.zeros_like(valid)
    if ids.size:
        always[ids] = side[ids] >= ALWAYS_SIDE * np.median(side[ids])
    always_ids = np.nonzero(always)[0].astype(np.int32)
    tree_ids = np.nonzero(valid & ~always)[0].astype(np.int32)
    n_always = int(always_ids.size)
    nodes = np.zeros((0, 8), np.float32)
    rows, depth = always_ids, 0
    if tree_ids.size:
        bvh = build_bvh(lo[tree_ids], hi[tree_ids], tree_ids)
        leaf = bvh.left == -1
        w0 = np.where(leaf, n_always + bvh.prim_start, bvh.right)
        w1 = np.where(leaf, bvh.prim_count, -1 - bvh.axis)
        nodes = np.concatenate([
            bvh.node_min, w0.astype(np.int32).view(np.float32)[:, None],
            bvh.node_max, w1.astype(np.int32).view(np.float32)[:, None]],
            axis=1)
        rows = np.concatenate([always_ids, bvh.prim_order])
        depth = _depth(bvh)
    pack = BvhPack(nodes=torch.from_numpy(np.ascontiguousarray(nodes)),
                   rows=torch.from_numpy(rows.astype(np.int32)),
                   n_always=n_always, depth=depth,
                   n_slots=int(sph24.shape[1]), shutter=shutter)
    if depth > BVH_STACK:
        raise ValueError(f"the BVH is {depth} levels deep, past the "
                         f"kernels' stack of {BVH_STACK}")
    moving = bool(np.any(sph24[4:7].detach().cpu().numpy()[:, valid]))
    if pack.smem_bytes(moving) > BVH_SMEM:
        raise ValueError(
            f"the BVH's {pack.n_nodes} nodes and {pack.n_rows} staged rows "
            f"take {pack.smem_bytes(moving)} bytes of shared memory, past "
            f"the kernels' {BVH_SMEM}")
    return pack.to(sph24.device)


def pack_scan(sph24) -> BvhPack:
    """The BvhPack whose walk is the linear scan over sph24's valid
    slots in slot order (every slot always tested, no node), on sph24's
    device: the reference the tree's walk is held to."""
    p = sph24.detach().cpu().numpy()
    rows = np.nonzero((p[7] > 0.5) & (p[3] >= 0.0))[0].astype(np.int32)
    return BvhPack(nodes=torch.zeros((0, 8), dtype=torch.float32),
                   rows=torch.from_numpy(rows), n_always=int(rows.size),
                   depth=0, n_slots=int(sph24.shape[1]),
                   shutter=None).to(sph24.device)


def _depth(bvh: BvhArrays) -> int:
    """Edges from the root to the deepest leaf, a level at a time."""
    depth, level = 0, np.zeros(1, np.int64)
    while True:
        inner = level[bvh.left[level] != -1]
        if inner.size == 0:
            return depth
        depth, level = depth + 1, np.concatenate([bvh.left[inner],
                                                  bvh.right[inner]])


# float32(1 + 2 gamma(3)) (rrt_tpu/utils/fp.py AABB_T_FAR_PAD).
FAR_PAD = float(np.float32(1.0 + 2.0 * (3 * _U / (1 - 3 * _U))))


def _walk_tree(o, d, bvh: BvhPack, t_min: float, t_best, test, node_tests,
               rays=None):
    """The kernels' walk over the tree of `bvh` (its nodes; the rows
    tested by `test(ray, row)`, both (K,) long, which updates t_best),
    one node a ray an iteration in the kernels' order, for the rays
    `rays` (default all): the slab test of each node's box padded by
    RAY_PAD times the ray origin's L1 norm, its far distance capped by
    the best t so far times FAR_PAD; the near child first."""
    dev = o.device
    nodes = bvh.nodes.to(dev)
    lo, hi = nodes[:, 0:3], nodes[:, 4:7]
    w0 = nodes[:, 3].contiguous().view(torch.int32).long()
    w1 = nodes[:, 7].contiguous().view(torch.int32).long()
    n = o.shape[1]
    pad = RAY_PAD * (o[0].abs() + o[1].abs() + o[2].abs())
    inv_d = 1.0 / d
    o_plus, o_minus = o + pad, o - pad
    stack = torch.zeros((n, bvh.depth + 2), dtype=torch.long, device=dev)
    sp = torch.zeros((n,), dtype=torch.long, device=dev)
    sp[slice(None) if rays is None else rays] = 1  # the root pushed
    while True:
        ray = (sp > 0).nonzero()[:, 0]
        if ray.numel() == 0:
            break
        sp[ray] -= 1
        node = stack[ray, sp[ray]]
        node_tests[ray] += 1
        t0 = (lo[node].T - o_plus[:, ray]) * inv_d[:, ray]
        t1 = (hi[node].T - o_minus[:, ray]) * inv_d[:, ray]
        near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
        t_near = torch.fmax(torch.fmax(near[0], near[1]),
                            torch.fmax(near[2], torch.full_like(
                                near[2], t_min)))
        t_far = torch.fmin(torch.fmin(far[0], far[1]),
                           torch.fmin(far[2], t_best[ray])) * FAR_PAD
        hit = t_near <= t_far
        inner = hit & (w1[node] < 0)
        leaf = hit & (w1[node] > 0)
        for k in range(LEAF_SIZE):
            use = leaf & (k < w1[node])
            test(ray[use], w0[node][use] + k)
        # Inner: the far child under the near one (popped first).
        r_in, n_in = ray[inner], node[inner]
        axis = -1 - w1[n_in]
        neg = d[axis, r_in] < 0.0
        left, right = n_in + 1, w0[n_in]
        stack[r_in, sp[r_in]] = torch.where(neg, left, right)
        stack[r_in, sp[r_in] + 1] = torch.where(neg, right, left)
        sp[r_in] += 2


def _seeded(t_seed, n, dev):
    """A walk's start: (t_best, win) INF and 0, or with a seed t the
    seed and win -1 where it is finite, which no tie replaces."""
    from .geometry import INF

    if t_seed is None:
        return (torch.full((n,), INF, dtype=torch.float32, device=dev),
                torch.zeros((n,), dtype=torch.long, device=dev))
    t_best = t_seed.to(torch.float32).clone()
    return t_best, torch.where(t_best < INF, -1, 0)


def _update(t_best, win, ray, t, slot):
    """Keep each ray's first minimum in slot order: a strictly smaller
    t, or an equal t of a lower slot."""
    better = (t < t_best[ray]) | ((t == t_best[ray]) & (slot < win[ray]))
    t_best[ray] = torch.where(better, t, t_best[ray])
    win[ray] = torch.where(better, slot, win[ray])


def bvh_closest_reference(o, d, sph24, bvh: BvhPack, *, t_min: float,
                          time=None, seed=None):
    """The kernels' walk (bounce.cuh closest_sphere_bvh) in plain
    PyTorch over the packed layout, each slot tested with
    intersect_only_reference's arithmetic, one node a ray an iteration
    in the kernel's order. o, d: (3, N); time: (N,) for moving spheres;
    seed: None, or (N,) another family's t, which a sphere must beat
    strictly (the kernel's seeded walk).
    Returns (t (N,), fam (N,) i32, idx (N,) i32: intersect_only's
    contract for the spheres, and with a seed t the seed where no sphere
    beats it, fam -1 and idx -1 there; node_tests (N,) i64, slot_tests
    (N,) i64)."""
    from .geometry import INF, dot

    dev = o.device
    n = o.shape[1]
    slot_of = bvh.rows.to(dev).long()
    c_rows = sph24[0:3][:, slot_of]  # (3, R)
    v_rows = sph24[4:7][:, slot_of]
    r_rows = sph24[18][slot_of]
    a = dot(d, d)
    o_dot_d, o_dot_o = dot(o, d), dot(o, o)
    inv_a = 1.0 / a
    t_best, win = _seeded(seed, n, dev)
    node_tests = torch.zeros((n,), dtype=torch.long, device=dev)
    slot_tests = torch.zeros((n,), dtype=torch.long, device=dev)

    def test(ray, row):
        """Rays `ray` test staged rows `row` (both (K,) long)."""
        c = c_rows[:, row]
        if time is not None:
            c = c + time[ray][None] * v_rows[:, row]
        cx, cy, cz = c[0], c[1], c[2]
        oo, dd = o[:, ray], d[:, ray]
        d_c = dd[0] * cx + dd[1] * cy + dd[2] * cz
        o_c = oo[0] * cx + oo[1] * cy + oo[2] * cz
        c_sq = cx * cx + cy * cy + cz * cz
        r = r_rows[row]
        half_b = o_dot_d[ray] - d_c
        c_coef = o_dot_o[ray] - 2.0 * o_c + c_sq - r * r
        disc = half_b * half_b - a[ray] * c_coef
        sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0)) * (disc > 0.0)
        root0 = (-half_b - sq) * inv_a[ray]
        root1 = (-half_b + sq) * inv_a[ray]
        ok = disc > 0.0
        in0 = ok & (root0 > t_min) & (root0 < INF)
        in1 = ok & (root1 > t_min) & (root1 < INF)
        t = torch.where(in0, root0, torch.where(in1, root1, INF))
        _update(t_best, win, ray, t, slot_of[row])
        slot_tests[ray] += 1

    everyone = torch.arange(n, device=dev)
    for j in range(bvh.n_always):
        test(everyone, torch.full((n,), j, dtype=torch.long, device=dev))
    if bvh.n_nodes:
        _walk_tree(o, d, bvh, t_min, t_best, test, node_tests)
    fam = torch.where((t_best < INF) & (win >= 0), 0, -1).to(torch.int32)
    return t_best, fam, win.to(torch.int32), node_tests, slot_tests


# ---------------------------------------------------------------------------
# The solid families' trees
# ---------------------------------------------------------------------------
#
# The forward kernels test the active quads, then the active boxes, each
# family seeded by the one before (ops/csrc/bounce.cuh closest_solid). A
# family of more than SOLID_CAP active slots is walked over a tree of
# its own (pack_solid_bvh), built by build_bvh over each slot's box and
# laid out as a BvhPack (its rows the family's slots), which the walk
# must leave with the loop's (t, slot) bit for bit, so a node may be
# skipped only when no slot inside it can give a hit at or below the
# best t under the kernels' arithmetic (quad_hit, box_hit). The rule:
#
#   * The hit a test reports at the computed t puts the exact point
#     o + t d within E = C u (|o| + S) / sin of the primitive, where S
#     is the primitive's size from the origin (a quad's |q|_1 + |u|_1 +
#     |v|_1, a box's |center|_1 + |half|_1), sin is a quad's sine of the
#     angle between its edges (1 for a box), and C is a few tens from the
#     operation counts: a quad's t = (n.q - o.n) / (d.n) leaves the point
#     within C u (|q| + |o| + |t d|) of the plane however grazing the ray
#     (the residual n.p - n.q is the division's and the dot products'
#     rounding), and its alpha, beta in [0, 1] within C u (...) |g| of
#     the edges (|g| |u| = 1 / sin); a box's slab bounds (rrt_tpu's
#     closed form -ob inv -/+ h |inv|) put the point's frame coordinates
#     within C u (|ob| + h) of [-h, h], and |t d| <= |o| + |p|. An axis
#     the ray is parallel to by slab's rule (|db| <= 1e-12, inv = 1e18)
#     bounds nothing, and the point drifts along it by |t db| <= 1e-12
#     |t|: a ray whose direction's largest component is below TINY_DIR
#     tests every box (the loop) instead of the tree, so the drift is at
#     most 1e-12 / TINY_DIR < 2^-19 of |p - o|.
#   * A slot's box is its exact extent (a quad's four corners; a box's
#     half extents turned by its cos and sin into world axes, divided by
#     cos^2 + sin^2, which the stored pair misses 1 by ulps) padded by
#     SOLID_K u S / sin, SOLID_K = 1024, rounded outward to float32; the
#     walk pads every node by RAY_PAD |o|_1 (65,536 u |o|) as the
#     spheres' walk does, which covers the |o| terms.
#   * A quad whose sine is below SOLID_MIN_SIN is tested by every segment
#     before the walk (its row among the first n_always), as the spheres'
#     large slots are; so are a family's slots when all of them are.
#   * The node test and the tie rule are the spheres' walk's: a node is
#     skipped only when its near distance exceeds the best t times
#     FAR_PAD; a slot replaces the best with a strictly smaller t or an
#     equal t and a lower slot, the loop's first minimum; seeded by the
#     quads' t, a box must beat it strictly.
#
# rttnw_final's 400 ground boxes share faces exactly (-1000 + 100 i is
# exact in float32), so equal t's between neighbours are common there.

# The active slots of a family the kernels loop over (at most this many,
# in every kernel; ops/megakernel.SOLID_CAP, csrc/bounce.cuh kSolidCap):
# the forward kernels walk a larger family's tree, the train kernels and
# chain_bwd do not take it.
SOLID_CAP = 64
SOLID_K = 1024.0
SOLID_MIN_SIN = 1.0 / 16.0
TINY_DIR = 2.0 ** -20  # bounce.cuh kTinyDir


@dataclasses.dataclass(frozen=True)
class SolidBvh:
    """The trees of a scene's active quads and boxes (rows: the family's
    slots; a family of at most SOLID_CAP, or whose every slot is always
    tested, has no node, and the kernels loop over it)."""

    quad: BvhPack
    box: BvhPack

    def smem_bytes(self) -> int:
        """Shared memory of the trees staged beside the solid rows: two
        float4 a node and an int a row (bounce.cuh solid_tree_bytes)."""
        return (32 * (self.quad.n_nodes + self.box.n_nodes)
                + 4 * (self.quad.n_rows + self.box.n_rows))

    def to(self, device) -> "SolidBvh":
        return dataclasses.replace(self, quad=self.quad.to(device),
                                   box=self.box.to(device))


def quad_slot_boxes(quad24, n: int):
    """The boxes of the first n quads of the quad pack (24, Q): (lo
    (n,3) f32, hi (n,3) f32, always (n,) bool), by the rule above."""
    p = quad24[:, :n].detach().cpu().to(torch.float64).numpy()
    q, u, v = p[0:3].T, p[3:6].T, p[6:9].T
    corners = np.stack([q, q + u, q + v, q + u + v])
    norm_u, norm_v = np.linalg.norm(u, axis=1), np.linalg.norm(v, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        sin = np.linalg.norm(np.cross(u, v), axis=1) / (norm_u * norm_v)
    always = ~(sin >= SOLID_MIN_SIN)  # NaN on a zero edge: always
    size = (np.abs(q).sum(1) + np.abs(u).sum(1) + np.abs(v).sum(1))
    pad = SOLID_K * _U * size / np.where(always, 1.0, sin)
    return (_outward(corners.min(0) - pad[:, None], True),
            _outward(corners.max(0) + pad[:, None], False), always)


def box_slot_boxes(box24, n: int):
    """The world boxes of the first n boxes of the box pack (24, B): (lo
    (n,3) f32, hi (n,3) f32), by the rule above."""
    p = box24[:, :n].detach().cpu().to(torch.float64).numpy()
    c, h, cs, sn = p[0:3].T, p[3:6].T, p[6], p[7]
    pad = SOLID_K * _U * (np.abs(c).sum(1) + np.abs(h).sum(1))
    hx, hy, hz = h[:, 0] + pad, h[:, 1] + pad, h[:, 2] + pad
    rho2 = cs * cs + sn * sn
    ext = np.stack([(np.abs(cs) * hx + np.abs(sn) * hz) / rho2, hy,
                    (np.abs(sn) * hx + np.abs(cs) * hz) / rho2], axis=1)
    ext = ext + pad[:, None]
    return _outward(c - ext, True), _outward(c + ext, False)


def _loop_pack(n: int) -> BvhPack:
    """The BvhPack of a family the kernels loop over: its n active slots,
    no node and no row."""
    return BvhPack(nodes=torch.zeros((0, 8), dtype=torch.float32),
                   rows=torch.zeros((0,), dtype=torch.int32), n_always=0,
                   depth=0, n_slots=n, shutter=None)


def family_bvh(lo, hi, always) -> BvhPack:
    """A family's tree over its slots' boxes lo, hi ((n, 3) f32, by the
    rule above), whatever its size; `always` (n,) bool the slots every
    segment tests before the walk (rows [0, n_always)). A family whose
    every slot is always tested is a loop (no node)."""
    n = lo.shape[0]
    tree_ids = np.nonzero(~always)[0].astype(np.int32)
    if tree_ids.size == 0:
        return _loop_pack(n)
    always_ids = np.nonzero(always)[0].astype(np.int32)
    n_always = int(always_ids.size)
    bvh = build_bvh(lo[tree_ids], hi[tree_ids], tree_ids)
    leaf = bvh.left == -1
    w0 = np.where(leaf, n_always + bvh.prim_start, bvh.right)
    w1 = np.where(leaf, bvh.prim_count, -1 - bvh.axis)
    nodes = np.concatenate([
        bvh.node_min, w0.astype(np.int32).view(np.float32)[:, None],
        bvh.node_max, w1.astype(np.int32).view(np.float32)[:, None]], axis=1)
    depth = _depth(bvh)
    if depth > BVH_STACK:
        raise ValueError(f"a solid family's tree is {depth} levels deep, "
                         f"past the kernels' stack of {BVH_STACK}")
    return BvhPack(nodes=torch.from_numpy(np.ascontiguousarray(nodes)),
                   rows=torch.from_numpy(np.concatenate(
                       [always_ids, bvh.prim_order]).astype(np.int32)),
                   n_always=n_always, depth=depth, n_slots=n, shutter=None)


def pack_solid_bvh(quad24, box24, n_quads: int, n_boxes: int) -> SolidBvh:
    """The kernels' SolidBvh over the first n_quads quads of the quad
    pack (24, Q) and the first n_boxes boxes of the box pack (24, B),
    built on the host, on quad24's device: the tree (family_bvh) of a
    family past SOLID_CAP active slots; a smaller one stays a loop, and
    its slots are not read."""
    quad = _loop_pack(n_quads)
    if n_quads > SOLID_CAP:
        quad = family_bvh(*quad_slot_boxes(quad24, n_quads))
    box = _loop_pack(n_boxes)
    if n_boxes > SOLID_CAP:
        box = family_bvh(*box_slot_boxes(box24, n_boxes),
                         np.zeros(n_boxes, bool))
    return SolidBvh(quad=quad, box=box).to(quad24.device)


def solid_scan(tree: SolidBvh) -> SolidBvh:
    """The SolidBvh whose families are loops over their active slots (no
    node), on tree's device: the reference the trees' walks are held
    to."""
    return SolidBvh(quad=_loop_pack(tree.quad.n_slots),
                    box=_loop_pack(tree.box.n_slots)).to(
                        tree.quad.nodes.device)


def solid_closest_reference(o, d, quad24, box24, tree: SolidBvh, *,
                            t_min: float):
    """The kernels' closest quad, then box (bounce.cuh closest_solid with
    the trees of `tree`) in plain PyTorch, each slot tested with
    geometry.quad_roots' and box_roots' arithmetic. o, d: (3, N).
    Returns (t (N,), fam (N,) i32: FAM_QUAD, FAM_BOX or FAM_NONE, idx
    (N,) i32, 0 on a miss: merge_solid's contract for the two families;
    node_tests (N,) i64, solid_tests (N,) i64)."""
    from .geometry import FAM_BOX, FAM_NONE, FAM_QUAD, INF, dot, quad_frames

    dev = o.device
    n = o.shape[1]
    nq, nb = tree.quad.n_slots, tree.box.n_slots
    fr = quad_frames(quad24[0:3, :nq], quad24[3:6, :nq], quad24[6:9, :nq])
    box = box24[:, :nb]
    d_len = torch.sqrt(dot(d, d))
    node_tests = torch.zeros((n,), dtype=torch.long, device=dev)
    solid_tests = torch.zeros((n,), dtype=torch.long, device=dev)

    def quad_t(ray, slot):
        oo, dd = o[:, ray], d[:, ray]
        nn, g, h = fr.n[:, slot], fr.g[:, slot], fr.h[:, slot]
        denom = dot(dd, nn)
        not_par = torch.abs(denom) > fr.eps_n[slot] * d_len[ray]
        t = (fr.d_plane[slot] - dot(oo, nn)) / torch.where(not_par, denom,
                                                             1.0)
        alpha = dot(oo, g) + t * dot(dd, g) - fr.q_g[slot]
        beta = dot(oo, h) + t * dot(dd, h) - fr.q_h[slot]
        ok = (not_par & (t > t_min) & (t < INF) & (alpha >= 0.0)
              & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0))
        return torch.where(ok, t, INF)

    def box_t(ray, slot):
        oo, dd = o[:, ray], d[:, ray]
        c, hf = box[0:3, slot], box[3:6, slot]
        cth, sth = box[6, slot], box[7, slot]
        wx, wy, wz = oo[0] - c[0], oo[1] - c[1], oo[2] - c[2]
        obs = (cth * wx - sth * wz, wy, sth * wx + cth * wz)
        dbs = (cth * dd[0] - sth * dd[2], dd[1], sth * dd[0] + cth * dd[2])
        lo = hi = None
        for k in range(3):
            par = torch.abs(dbs[k]) <= 1e-12
            inv = torch.where(par, 1e18, 1.0 / torch.where(par, 1.0, dbs[k]))
            a_t = obs[k] * inv
            b_t = hf[k] * torch.abs(inv)
            k_lo, k_hi = -a_t - b_t, b_t - a_t
            lo = k_lo if lo is None else torch.maximum(lo, k_lo)
            hi = k_hi if hi is None else torch.minimum(hi, k_hi)
        t = torch.where(lo > t_min, lo, hi)
        ok = (lo < hi) & (t > t_min) & (t < INF)
        return torch.where(ok, t, INF)

    def family(pack: BvhPack, slot_t, t_seed, n_slots):
        t_best, win = _seeded(t_seed, n, dev)
        slot_of = pack.rows.to(dev).long()

        def test(ray, slot):
            _update(t_best, win, ray, slot_t(ray, slot), slot)
            solid_tests[ray] += 1

        everyone = torch.arange(n, device=dev)
        if pack.n_nodes == 0:  # the loop
            for i in range(n_slots):
                test(everyone, torch.full((n,), i, dtype=torch.long,
                                          device=dev))
            return t_best, win
        for j in range(pack.n_always):
            test(everyone, slot_of[j].expand(n))
        if slot_t is box_t:  # a ray too short for the slabs' bound loops
            tiny = torch.amax(d.abs(), dim=0) < TINY_DIR
            for i in range(n_slots):
                test(everyone[tiny], torch.full((int(tiny.sum()),), i,
                                                dtype=torch.long, device=dev))
            rays = (~tiny).nonzero()[:, 0]
        else:
            rays = everyone
        _walk_tree(o, d, pack, t_min, t_best,
                   lambda ray, row: test(ray, slot_of[row]), node_tests,
                   rays=rays)
        return t_best, win

    tq, wq = family(tree.quad, quad_t, None, nq)
    tb, wb = family(tree.box, box_t, tq, nb)
    use_b = tb < tq
    t = torch.where(use_b, tb, tq)
    fam = torch.where(use_b, FAM_BOX, torch.where(tq < INF, FAM_QUAD,
                                                  FAM_NONE))
    idx = torch.where(use_b, wb, torch.where(tq < INF, wq, 0))
    return (t, fam.to(torch.int32), idx.to(torch.int32), node_tests,
            solid_tests)
