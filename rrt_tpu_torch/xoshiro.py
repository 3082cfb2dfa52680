"""Host-side xoshiro128+ — bit-exact reproduction of the reference's scene
RNG draw sequence.

The reference builds its random scenes by drawing from a seeded
`rand_xoshiro::Xoshiro128Plus` (reference: src/rng.rs:14, src/chap12.rs:20-70),
so reproducing the *layouts* bit-for-bit requires the same generator and the
same float-from-bits conventions:

  * `seed_from_u64`: SplitMix64 expands the u64 seed into the 16-byte state
    (rand_core's default implementation);
  * `gen::<f32>()`: top 24 bits scaled by 2^-24  (rand `Standard` for f32);
  * `Uniform::new_inclusive(lo, hi)`: 23 mantissa bits into [1,2), minus 1,
    times (hi-lo)/(1 - 2^-24), plus lo  (rand `UniformFloat<f32>`).

This generator is used only on the host at scene-build time; device-side
randomness is counter-based threefry (rrt_tpu_torch.rng). The
render-noise streams are intentionally NOT reproduced (the reference's
per-thread jump-ahead streams are schedule-dependent anyway, SURVEY.md
§1). This module is pure Python and is the same as rrt_tpu.xoshiro, so
the port builds the same scene layouts without importing JAX.
"""

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _splitmix64(state: int):
    state = (state + 0x9E3779B97F4A7C15) & _MASK64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z = z ^ (z >> 31)
    return state, z


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _MASK32


class Xoshiro128Plus:
    """Minimal xoshiro128+ with rand-compatible seeding and f32 draws."""

    def __init__(self, seed_u64: int):
        sm = seed_u64 & _MASK64
        raw = b""
        for _ in range(2):
            sm, z = _splitmix64(sm)
            raw += z.to_bytes(8, "little")
        self.s = [int.from_bytes(raw[i * 4:(i + 1) * 4], "little")
                  for i in range(4)]
        if all(w == 0 for w in self.s):  # the all-zero state is invalid
            self.s = [1, 0, 0, 0]

    def clone(self) -> "Xoshiro128Plus":
        c = Xoshiro128Plus.__new__(Xoshiro128Plus)
        c.s = list(self.s)
        return c

    def next_u32(self) -> int:
        s = self.s
        result = (s[0] + s[3]) & _MASK32
        t = (s[1] << 9) & _MASK32
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = _rotl(s[3], 11)
        return result

    def gen_f32(self) -> float:
        """rand `Standard` f32: uniform in [0,1) from the top 24 bits."""
        return (self.next_u32() >> 8) * (1.0 / (1 << 24))

    def uniform_inclusive(self, low: float, high: float) -> float:
        """rand `UniformFloat<f32>::new_inclusive` sample.

        Every arithmetic step rounds through f32, reproducing rand's
        `UniformFloat<f32>` exactly (including the constructor's
        scale-decrement loop), so the draw stream is bit-exact rather
        than ~1-ulp close (the moving-sphere dy draws in book2chap2 are
        sensitive to this)."""
        import struct

        import numpy as np
        f32 = np.float32
        low32, high32 = f32(low), f32(high)
        max_rand = f32(f32(1.0) - f32(2.0 ** -24))
        scale = f32(f32(high32 - low32) / max_rand)
        # rand decrements scale until scale * max_rand + low <= high.
        while not (f32(f32(scale * max_rand) + low32) <= high32):
            scale = np.nextafter(scale, f32(0.0), dtype=f32)
        x = self.next_u32() >> 9  # 23 mantissa bits
        value1_2 = f32(struct.unpack("<f", struct.pack(
            "<I", 0x3F800000 | x))[0])
        value0_1 = f32(value1_2 - f32(1.0))
        return float(f32(f32(value0_1 * scale) + low32))
