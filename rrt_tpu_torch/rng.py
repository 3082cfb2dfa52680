"""Counter-based, stateless random sampling (Threefry-2x32).

Every draw is a pure function of (seed, pixel, sample, bounce, stream),
so a (pixel, sample) path has the same radiance whatever the batch,
chunk or launch shape. The words are bit-identical to the JAX package's
`rrt_tpu.rng`; the float samplers built on them agree up to the ulps of
the transcendental functions.

Unsigned 32-bit words are carried in int64 tensors and masked with
0xFFFFFFFF after every add and shift: PyTorch's uint32 arithmetic is
partial on the CPU, and int64 holds every intermediate of the hash
(a rotate's left shift needs at most 32+29 bits) exactly. The CUDA
kernel (ops/csrc/tile_render.cu) computes the same hash on uint32_t.

Rejection sampling is replaced by closed-form samplers of the same
distributions:

  * unit vector        = gaussian / ||gaussian||  (Box-Muller)
  * in unit sphere     = unit vector * cbrt(U)
  * in unit disc       = sqrt(U) * (cos 2 pi V, sin 2 pi V)
"""

import math

import torch

# Stream ids: every distinct consumer of randomness inside one bounce gets
# its own stream (the bounce/stream counter is bounce * 8 + stream).
STREAM_CAMERA = 0  # pixel jitter (2) + lens disc (2) + shutter time (1)
STREAM_SCATTER = 1  # lambertian/metal/isotropic dirs + dielectric choice
STREAM_MEDIUM = 2  # constant-medium distance sampling
STREAM_RR = 3  # the Russian-roulette continuation test

_NUM_STREAMS = 8

MASK32 = 0xFFFFFFFF
PAIR_STEP = 0x9E3779B9  # word-pair constant: pair * PAIR_STEP + pair
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _u32(x, like=None):
    """A python int or tensor as an int64 tensor of u32 values."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    device = like.device if like is not None else None
    return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds) on u32 words held in int64 tensors or
    python ints (broadcastable). Returns two int64 tensors of u32 words
    of the broadcast shape."""
    like = next((v for v in (c0, c1, k0, k1)
                 if isinstance(v, torch.Tensor)), None)
    k0, k1 = _u32(k0, like), _u32(k1, like)
    x0 = (_u32(c0, like) + k0) & MASK32
    x1 = (_u32(c1, like) + k1) & MASK32
    ks2 = k0 ^ k1 ^ _PARITY
    injections = ((k1, ks2, 1), (ks2, k0, 2), (k0, k1, 3), (k1, ks2, 4),
                  (ks2, k0, 5))
    for i, (a, b, n) in enumerate(injections):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + a) & MASK32
        x1 = (x1 + b + n) & MASK32
    return x0, x1


def _seed_words(seed):
    """An int (low word, high word) or a pair of u32 words."""
    if isinstance(seed, int):
        return seed & MASK32, (seed >> 32) & MASK32
    s0, s1 = seed
    return int(s0) & MASK32, int(s1) & MASK32


def key_words(seed: int):
    """The key words of a render seed: (high word, low word), the words
    of the reference renderer's jax.random.key(seed). Note the order is
    the reverse of `_seed_words(seed)`."""
    return (seed >> 32) & MASK32, seed & MASK32


def sample_keys(seed, pixel_gid, sample_id):
    """Per-ray sample key words, shape (2, N) int64 holding u32 values.

    pixel_gid: (N,) global pixel index py*W+px. sample_id: int or (N,).
    """
    s0, s1 = _seed_words(seed)
    gid = _u32(pixel_gid)
    sid = torch.broadcast_to(_u32(sample_id, gid), gid.shape)
    k0, k1 = threefry2x32(s0, s1, gid, sid)
    return torch.stack([k0, k1], dim=0)


def u32_bits(words):
    """u32 words held in int64 -> an int32 tensor of the same 32 bits,
    which a CUDA kernel reads as uint32_t."""
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32),
                       words).to(torch.int32)


def from_u32_bits(bits):
    """The inverse of u32_bits: int32 bits -> u32 words in int64."""
    return bits.to(torch.int64) & MASK32


def _words(keys, counter, n_words: int):
    """n_words u32 streams for this (bounce*8+stream) counter.
    keys: (2, N) rows. Returns (n_words, N) int64."""
    k0, k1 = keys[0], keys[1]
    counter = torch.broadcast_to(_u32(counter, k0), k0.shape)
    outs = []
    for pair in range((n_words + 1) // 2):
        a, b = threefry2x32(k0, k1, counter, pair * PAIR_STEP + pair)
        outs += [a, b]
    return torch.stack(outs[:n_words], dim=0)


def _to_uniform(bits):
    """u32 -> float32 in [0, 1) from the top 24 bits (through int32, as
    the reference does; exact for values below 2^24)."""
    return (bits >> 8).to(torch.int32).to(torch.float32) * (1.0 / (1 << 24))


def _counter(bounce, stream: int):
    if isinstance(bounce, torch.Tensor):
        return bounce.to(torch.int64) * _NUM_STREAMS + stream
    return int(bounce) * _NUM_STREAMS + stream


def uniform_words(keys, bounce, stream: int, n: int):
    """(n, N) float32 uniforms in [0,1) for one (bounce, stream)."""
    return _to_uniform(_words(keys, _counter(bounce, stream), n))


def _cbrt01(u):
    """cbrt for u in [0,1) as exp(log(u)/3), the reference's form."""
    return torch.exp(torch.log(torch.clamp(u, min=1e-12)) * (1.0 / 3.0))


def _box_muller(u1, u2):
    """Two iid standard normals from two uniforms."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u1, min=1e-12)))
    th = (2.0 * math.pi) * u2
    return r * torch.cos(th), r * torch.sin(th)


def _normalize3_rows(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def camera_draws(keys):
    """(jx, jy, disc_x, disc_y, time_u), each (N,), for the camera ray."""
    u = uniform_words(keys, 0, STREAM_CAMERA, 5)
    r = torch.sqrt(u[2])
    theta = (2.0 * math.pi) * u[3]
    return u[0], u[1], r * torch.cos(theta), r * torch.sin(theta), u[4]


def scatter_draws(keys, bounce):
    """(unit vector (3,N), in-sphere point (3,N), choice (N,)) for one
    bounce."""
    u = uniform_words(keys, bounce, STREAM_SCATTER, 8)
    g0, g1 = _box_muller(u[0], u[1])
    g2, g3 = _box_muller(u[2], u[3])
    g4, g5 = _box_muller(u[4], u[5])
    unit = torch.stack(_normalize3_rows(g0, g1, g2))
    radius = _cbrt01(u[6])
    sphere = torch.stack(_normalize3_rows(g3, g4, g5)) * radius
    return unit, sphere, u[7]


def medium_draws(keys, bounce, n_media: int):
    """(n_media, N) uniforms for constant-medium distance sampling, one
    a medium slot (media-major). The kernels draw the same words in
    pairs: medium i reads word i % 2 of pair i // 2 of the counter
    bounce * 8 + STREAM_MEDIUM."""
    return uniform_words(keys, bounce, STREAM_MEDIUM, n_media)


def rr_draw(keys, bounce):
    """(N,) uniform for the Russian-roulette continuation test at this
    bounce (STREAM_RR): word a of threefry2x32(k0, k1, bounce * 8 + 3,
    0), the word the kernels draw (csrc/bounce.cuh rr_uniform)."""
    return uniform_words(keys, bounce, STREAM_RR, 1)[0]
