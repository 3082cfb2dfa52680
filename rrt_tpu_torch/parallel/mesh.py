"""Sharded rendering and training over a (dp, sp) mesh of processes.

The counterpart of rrt_tpu's `parallel/mesh.py` on torch.distributed.
One process drives one device, PyTorch's idiom: rrt_tpu's
single-process mesh of N devices is N processes here, each calling the
same function with the same arguments (SPMD), ranks numbered as the
mesh's devices are in rrt_tpu (rank = dp_rank * sp + sp_rank).

Mesh axes, as rrt_tpu's:

  "dp"  the image's rows: dp rank i renders the band of rows
        [i * H // dp, (i + 1) * H // dp) through the kernels' row window
        (ops.megakernel.check_window). rrt_tpu shards pixel-meta blocks;
        the port's kernels run one thread a pixel in 16x16 blocks, so a
        band of rows is the natural share;
  "sp"  the samples: sp rank j renders samples [j * n / sp, (j + 1) *
        n / sp) of its band's n (a chunk's, in the chunked trainer).

Each rank writes its band's radiance sums into a zero (P, 3) buffer and
one all_reduce over the world assembles the image and sums the samples
(rrt_tpu's psum over ("dp", "sp")). Keys are (pixel, sample) addressed
in the whole image, so a rank's band is the single-device render's rows
bit for bit: under sp = 1 the assembled image is the single-device one
bit for bit (its sum adds zeros), under sp > 1 up to the order of the
samples' f32 sum.

Gradients: the loss is computed identically on every rank from the
assembled, replicated image. The assembly's transpose hands each rank
that cotangent unchanged (`_SumOverWorld`'s backward is the identity,
not an all_reduce, which would scale every gradient by the world size),
restricted to its band by the padding's transpose; the differentiable
scene and camera tensors enter through `replicate_leaves`, whose
backward all-reduces (sums) their gradients over the world: the
transpose of rrt_tpu's replicated P() inputs. After a backward every
rank holds the full gradient, so every rank's SGD step gives the same
parameters bit for bit.

Only all_reduce and broadcast are used (the ranks' host names go
through the TCP store before the group exists: place), the two
collectives gloo takes for CUDA tensors as well as CPU ones: ranks that share one card (NCCL
refuses two ranks on one device) run under gloo, with the kernels on
the card.
"""

import contextlib
import dataclasses
import datetime
import socket

import torch
import torch.distributed as dist

from .. import render as _render
from ..camera import Camera
from ..ops import megakernel as ops_mega
from ..scene import SceneArrays, tensor_fields

# How long a rank waits for the others (process group set-up and every
# collective) before it raises.
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a rank runs on its host."""

    backend: str  # the process group's: "nccl" or "gloo"
    device: torch.device  # the device this rank drives
    share: int  # the ranks of its host on that device (or host memory)


def place(hosts: list, rank: int, device) -> Placement:
    """Rank `rank`'s Placement, given every rank's host name in rank
    order. The ranks on its host take the cards in rank order when the
    host has a card for each (`device` a CUDA device): card i for the
    host's i-th rank, under nccl. Otherwise they share `device` (a card's
    index made explicit) under gloo, which NCCL's refusal of two ranks on
    one card leaves: the kernels still run on the card."""
    device = torch.device(device)
    local = [i for i, h in enumerate(hosts) if h == hosts[rank]]
    if (device.type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() >= len(local)):
        return Placement("nccl" if dist.is_nccl_available() else "gloo",
                         torch.device("cuda", local.index(rank)), 1)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
    return Placement("gloo", device, len(local))


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int, *, backend: str | None = None,
                           device="cuda") -> Placement:
    """Join the process group of `num_processes` ranks as rank
    `process_id`, rank 0's TCP store at `coordinator_address`
    ("host:port"); one call a process before any collective. The ranks
    first trade host names through the store, so each knows its host's
    ranks (place(...) on `device`); backend None: the Placement's.
    Returns the Placement, with the backend the group runs."""
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=TIMEOUT)
    store.set(f"host/{process_id}", socket.gethostname())
    hosts = [store.get(f"host/{i}").decode() for i in range(num_processes)]
    placement = place(hosts, process_id, device)
    if backend is not None:
        placement = dataclasses.replace(placement, backend=backend)
    dist.init_process_group(placement.backend, store=store,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return placement


def flags_error(coordinator, num_processes, process_id) -> str | None:
    """The message for a launch that gives some of the three distributed
    flags but not all (it would wait for ranks that never come), else
    None."""
    given = [f is not None for f in (coordinator, num_processes, process_id)]
    if any(given) and not all(given):
        return ("a sharded run needs all of --coordinator, --num-processes "
                "and --process-id")
    return None


def _parse_mesh(spec: str | None):
    if spec is None:
        return None, None
    try:
        dp, sp = (int(x) for x in spec.lower().split("x"))
        if dp > 0 and sp > 0:
            return dp, sp
    except ValueError:
        pass
    raise ValueError(f"a mesh is DPxSP with positive integers, got {spec!r}")


@contextlib.contextmanager
def from_flags(coordinator, num_processes, process_id, mesh: str | None,
               device):
    """A command's distributed set-up from its flags: yields (Mesh,
    backend). With the three flags, this rank joins their process group
    (initialize_distributed), drives its Placement's device, and leaves
    the group on exit; without them, a world of one on `device` (backend
    "none"). mesh: "DPxSP", or None for factorize's default. Raises
    ValueError for some of the three flags without the others
    (flags_error)."""
    error = flags_error(coordinator, num_processes, process_id)
    if error:
        raise ValueError(error)
    if coordinator is None:
        device = torch.device(device)
        if device.type == "cuda":
            device = torch.device("cuda", device.index or 0)
        placement = Placement("none", device, 1)
    else:
        placement = initialize_distributed(coordinator, num_processes,
                                           process_id, device=device)
    try:
        if placement.device.type == "cuda":
            torch.cuda.set_device(placement.device)
        dp, sp = _parse_mesh(mesh)
        yield (make_mesh(dp, sp, device=placement.device,
                         share=placement.share), placement.backend)
    finally:
        if coordinator is not None:
            dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, sp) mesh of dp * sp processes."""

    dp: int
    sp: int
    dp_rank: int
    sp_rank: int
    device: torch.device
    share: int = 1  # ranks of the world on this rank's device

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def rank(self) -> int:
        return self.dp_rank * self.sp + self.sp_rank


def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def factorize(n: int, dp: int | None = None, sp: int | None = None):
    """rrt_tpu's make_mesh rule for n devices: without dp and sp, sp is
    the largest power of two at most sqrt(n) and dp = n // sp; one given,
    the other divides n by it. Raises ValueError when dp * sp != n."""
    if dp is None and sp is None:
        sp = 1
        while sp * 2 <= max(1, int(n ** 0.5)):
            sp *= 2
        dp = n // sp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp={dp * sp} != world size {n}")
    return dp, sp


def make_mesh(dp: int | None = None, sp: int | None = None, *, device,
              share: int = 1) -> Mesh:
    """This rank's Mesh over the process group's world (a world of one
    without a process group), factorized by `factorize`; device: the
    device this rank drives, share: the ranks on it (a Placement's).
    Every rank calls it."""
    world, rank = _world()
    dp, sp = factorize(world, dp, sp)
    return Mesh(dp, sp, rank // sp, rank % sp, torch.device(device), share)


def check_world(mesh: Mesh):
    """Raise ValueError unless the mesh spans the process group's world
    (a world of one without a process group)."""
    world, rank = _world()
    if mesh.size != world or mesh.rank != rank:
        raise ValueError(
            f"a {mesh.dp}x{mesh.sp} mesh at rank {mesh.rank} does not match "
            f"the process group's world of {world} at rank {rank}")


def band(mesh: Mesh, height: int):
    """This dp rank's rows [row_lo, row_hi) of an image `height` rows
    tall (the dp bands partition the rows, in rank order); checks the
    mesh against the world first (check_world), so every sharded route
    raises for a mesh of another world."""
    check_world(mesh)
    if height < mesh.dp:
        raise ValueError(f"an image of {height} rows cannot give each of "
                         f"dp={mesh.dp} ranks a row")
    return (mesh.dp_rank * height // mesh.dp,
            (mesh.dp_rank + 1) * height // mesh.dp)


def max_band_rows(mesh: Mesh, height: int) -> int:
    """The rows of the tallest band (resolve_spp_chunk's per-rank
    pixels)."""
    return -(-height // mesh.dp)


def sample_range(mesh: Mesh, n_samples: int):
    """This sp rank's samples (first, count) of [0, n_samples); raises
    ValueError unless sp divides n_samples."""
    if n_samples % mesh.sp != 0:
        raise ValueError(f"n_samples={n_samples} must be a multiple of "
                         f"sp={mesh.sp}")
    local = n_samples // mesh.sp
    return mesh.sp_rank * local, local


class _SumOverWorld(torch.autograd.Function):
    """Forward: the all_reduce sum of x over the world (a copy). Backward:
    the identity: every rank computes the same loss from the same sum,
    so each holds the whole cotangent already; summing it again would
    scale every gradient by the world size."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


class _Replicated(torch.autograd.Function):
    """Forward: the identity (a copy) on a tensor every rank holds alike.
    Backward: the all_reduce sum of its gradient over the world, the
    transpose of handing one tensor to every rank."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def world_sum(mesh: Mesh, x):
    """The sum of x over the world (no gradient), x itself on a world
    of one."""
    if mesh.size == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def assemble(mesh: Mesh, part, row_lo: int, row_hi: int,
             cfg: _render.RenderConfig):
    """The image's radiance sums (P, 3) from each rank's `part`, its
    band's sums ((row_hi - row_lo) * width, 3): zeros outside the band,
    then _SumOverWorld (differentiable; the band's cotangent is the
    assembled image's rows)."""
    full = torch.nn.functional.pad(
        part, (0, 0, row_lo * cfg.width, (cfg.height - row_hi) * cfg.width))
    return full if mesh.size == 1 else _SumOverWorld.apply(full)


def replicate_leaves(mesh: Mesh, scene: SceneArrays, camera: Camera):
    """The scene's and camera's tensors that require grad, moved to the
    mesh's device and passed through one _Replicated (flattened into one
    buffer, so a backward makes one all_reduce): their gradients on
    every rank become the sum over the world's shares. Returns (scene,
    camera); unchanged on a world of one or without such tensors."""
    names = [n for n in tensor_fields() if getattr(scene, n).requires_grad]
    cam_names = [f.name for f in dataclasses.fields(Camera)
                 if getattr(camera, f.name).requires_grad]
    if mesh.size == 1 or not names + cam_names:
        return scene, camera
    ts = ([getattr(scene, n) for n in names]
          + [getattr(camera, n) for n in cam_names])
    flat = torch.cat([t.to(mesh.device, torch.float32).reshape(-1)
                      for t in ts])
    pieces = _Replicated.apply(flat).split([t.numel() for t in ts])
    pieces = [p.reshape(t.shape) for p, t in zip(pieces, ts)]
    scene = dataclasses.replace(scene, **dict(zip(names, pieces)))
    camera = dataclasses.replace(camera, **dict(zip(
        cam_names, pieces[len(names):])))
    return scene, camera


# ---------------------------------------------------------------------------
# The sharded routes, one for each of rrt_tpu's. Every rank calls them.
# ---------------------------------------------------------------------------


def trace_tiles_sharded(scene: SceneArrays, camera, cfg, seed, mesh: Mesh):
    """Every sample of every pixel over the mesh through the tile kernel
    (render.trace_tiles on this rank's band and samples), assembled:
    (radiance sums (P,3), n_traced), on every rank."""
    row_lo, row_hi = band(mesh, cfg.height)
    lo, n = sample_range(mesh, cfg.spp)
    rad, n_traced = _render.trace_tiles(
        scene, camera, cfg, seed, sample_lo=lo, n_samples=n,
        device=mesh.device, row_lo=row_lo, row_hi=row_hi)
    return (assemble(mesh, rad, row_lo, row_hi, cfg),
            world_sum(mesh, n_traced))


def render_image_tiles_sharded(scene: SceneArrays, camera, cfg, seed,
                               mesh: Mesh):
    """The (H,W,3) mean-radiance image over the mesh through the tile
    kernel, and n_traced."""
    rad, n_traced = trace_tiles_sharded(scene, camera, cfg, seed, mesh)
    return rad.reshape(cfg.height, cfg.width, 3) / float(cfg.spp), n_traced


def trace_tiles_diff_sharded(scene: SceneArrays, camera, cfg, seed,
                             mesh: Mesh):
    """Every sample over the mesh, differentiable, through the train
    kernels (render.trace_tiles_diff on this rank's band and samples),
    assembled: (radiance sums (P,3), n_traced). A backward from a loss
    of the sums leaves every rank the whole gradient (replicate_leaves,
    _SumOverWorld)."""
    row_lo, row_hi = band(mesh, cfg.height)
    lo, n = sample_range(mesh, cfg.spp)
    scene, camera = replicate_leaves(mesh, scene, camera)
    rad, n_traced = _render.trace_tiles_diff(
        scene, camera, cfg, seed, sample_lo=lo, n_samples=n,
        device=mesh.device, row_lo=row_lo, row_hi=row_hi)
    return (assemble(mesh, rad, row_lo, row_hi, cfg),
            world_sum(mesh, n_traced))


def render_image_sharded(scene: SceneArrays, camera, cfg, seed, mesh: Mesh,
                         differentiable: bool = False):
    """The batch driver over the mesh (rrt_tpu's render_image_sharded):
    this rank's band in tiles of cfg.tile_pixels, its share of the
    sample passes (render.render_tile), assembled. differentiable: the
    bounce chain's route, whose gradients every rank then holds whole.
    Returns (image (H,W,3) mean radiance, n_traced)."""
    ops_mega.check_scope(scene, eager=mesh.device.type == "cpu")
    if differentiable:
        _render._check_chain_card_scope(
            "render_image_sharded(differentiable=True)", scene, mesh.device)
    spc = cfg.samples_per_pass
    if cfg.spp % spc != 0:
        raise ValueError("spp must be a multiple of samples_per_pass")
    n_passes = cfg.spp // spc
    if n_passes % mesh.sp != 0:
        raise ValueError(f"spp/samples_per_pass={n_passes} must be a "
                         f"multiple of the sp axis ({mesh.sp})")
    local = n_passes // mesh.sp
    device = _render._check_device(mesh.device)
    row_lo, row_hi = band(mesh, cfg.height)
    scene, camera = scene.to(device), camera.to(device)
    if differentiable:
        scene, camera = replicate_leaves(mesh, scene, camera)
    with torch.no_grad():
        packed = _render.pack_scene(scene, device, _render._shutter(camera))
    ids = torch.arange(row_lo * cfg.width, row_hi * cfg.width, device=device)
    rads, n_traced = [], 0
    for tile in torch.split(ids, cfg.tile_pixels):
        r, n = _render.render_tile(
            scene, camera, tile % cfg.width, tile // cfg.width, cfg, seed,
            mesh.sp_rank * local, local, differentiable, packed=packed)
        rads.append(r)
        n_traced = n_traced + n
    rad = assemble(mesh, torch.cat(rads), row_lo, row_hi, cfg)
    image = rad.reshape(cfg.height, cfg.width, 3) / float(cfg.spp)
    return image, world_sum(mesh, torch.as_tensor(n_traced, device=device))


def render_image_diff_sharded(scene: SceneArrays, camera, cfg, seed,
                              mesh: Mesh):
    """Differentiable full image over the mesh, through the train kernels
    when they cover the scene and depth (trace_tiles_diff_sharded), else
    the batch driver's chain (render_image_sharded(differentiable=True))
    after one log line, as render.render_image_diff routes; on a CUDA
    device a scene outside the train kernels' scope raises. Returns
    (image (H,W,3) mean radiance, n_traced)."""
    _render._check_card_scope("render_image_diff_sharded", scene,
                              mesh.device)
    reason = _render.diff_fallback_reason(scene, cfg)
    if reason is not None:
        _render._warn_diff_fallback("render_image_diff_sharded", reason)
        return render_image_sharded(scene, camera, cfg, seed, mesh,
                                    differentiable=True)
    rad, n = trace_tiles_diff_sharded(scene, camera, cfg, seed, mesh)
    return rad.reshape(cfg.height, cfg.width, 3) / float(cfg.spp), n


def trace_queue_sharded(scene: SceneArrays, camera, cfg, seed, mesh: Mesh):
    """The queue driver over the mesh: this rank's band of pixels and its
    share of the samples through render.trace_queue, assembled:
    (radiance sums (P,3), n_traced), on every rank."""
    row_lo, row_hi = band(mesh, cfg.height)
    lo, n = sample_range(mesh, cfg.spp)
    ids = torch.arange(row_lo * cfg.width, row_hi * cfg.width)
    rad, n_traced = _render.trace_queue(
        scene, camera, ids % cfg.width, ids // cfg.width, cfg, seed, lo,
        lo + n, device=mesh.device)
    return (assemble(mesh, rad, row_lo, row_hi, cfg),
            world_sum(mesh, n_traced))


def render_image_queue_sharded(scene: SceneArrays, camera, cfg, seed,
                               mesh: Mesh):
    """The (H,W,3) mean-radiance image over the mesh through the queue
    driver (trace_queue_sharded), and n_traced."""
    rad, n_traced = trace_queue_sharded(scene, camera, cfg, seed, mesh)
    return rad.reshape(cfg.height, cfg.width, 3) / float(cfg.spp), n_traced


def broadcast_int(mesh: Mesh, value: int) -> int:
    """Rank 0's integer on every rank (a world of one: value)."""
    if mesh.size == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, 0)
    return int(t.item())
