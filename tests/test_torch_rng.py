"""rrt_tpu_torch.rng against rrt_tpu.rng on the same words.

The Threefry words, the sample keys and the u32 -> f32 conversion must
be bit-identical; the float samplers built on them may differ only by
the ulps of log/sin/cos/exp/rsqrt, so they compare with
allclose(rtol=1e-6, atol=1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu import rng as jrng
from rrt_tpu_torch import rng as trng

N = 4096


def _u32(seed, n=N):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=n,
                                                dtype=np.uint64).astype(
                                                    np.uint32)


def _t(words):
    return torch.from_numpy(words.astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("case", ["random", "wrap"])
def test_threefry_words_bit_exact(case):
    k0, k1, c0, c1 = (_u32(i) for i in range(4))
    if case == "wrap":
        # Counters and keys whose sums pass 2^32 in the first injection.
        c0 = (np.uint32(0xFFFFFFFF) - np.arange(N, dtype=np.uint32))
        c1 = np.full(N, 0xFFFFFFF0, np.uint32)
        k0 = k0 | np.uint32(0x80000000)
    a_j, b_j = jrng.threefry2x32(jnp.asarray(k0), jnp.asarray(k1),
                                 jnp.asarray(c0), jnp.asarray(c1))
    a_t, b_t = trng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    np.testing.assert_array_equal(_np(a_t), np.asarray(a_j))
    np.testing.assert_array_equal(_np(b_t), np.asarray(b_j))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 + 5])
def test_sample_keys_bit_exact(seed):
    gid = _u32(11)
    for sample in (0, 3, 0xFFFFFFFF):
        kj = jrng.sample_keys(seed, jnp.asarray(gid), np.uint32(sample))
        kt = trng.sample_keys(seed, _t(gid), sample)
        np.testing.assert_array_equal(_np(kt), np.asarray(kj))


def test_key_words_match_the_reference_render_key():
    """The render path keys on jax.random.key(seed), whose words are
    (high, low) — the reverse of rng._seed_words(int)."""
    for seed in (0, 7, 123456789):
        ref = jrng._seed_words(jax.random.key(seed))
        assert trng.key_words(seed) == tuple(int(w) for w in ref)
    assert trng.key_words(7) == (0, 7)
    assert trng._seed_words(7) == (7, 0)


def test_to_uniform_bit_exact():
    bits = np.concatenate([_u32(3), np.array([0, 255, 256, 0xFFFFFFFF,
                                              0x80000000], np.uint32)])
    got = trng._to_uniform(_t(bits)).numpy()
    exp = np.asarray(jrng._to_uniform(jnp.asarray(bits)))
    np.testing.assert_array_equal(got.view(np.uint32), exp.view(np.uint32))
    assert got.max() < 1.0 and got.min() >= 0.0


def _keys(seed):
    gid = _u32(seed, 2048)
    kj = jrng.sample_keys(seed, jnp.asarray(gid), seed)
    return kj, torch.from_numpy(np.asarray(kj).astype(np.int64))


def test_camera_draws_close():
    kj, kt = _keys(5)
    for got, exp in zip(trng.camera_draws(kt), jrng.camera_draws(kj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bounce", [0, 1, 49])
def test_scatter_draws_close(bounce):
    kj, kt = _keys(9 + bounce)
    unit_t, sph_t, choice_t = trng.scatter_draws(kt, bounce)
    unit_j, sph_j, choice_j = jrng.scatter_draws(kj, bounce)
    np.testing.assert_allclose(unit_t.numpy(), np.stack(unit_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sph_t.numpy(), np.stack(sph_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(choice_t.numpy(), np.asarray(choice_j))


def test_per_ray_bounce_counter():
    """A (N,) bounce tensor addresses the same words as a scalar."""
    _, kt = _keys(4)
    bounce = torch.full((kt.shape[1],), 6, dtype=torch.int64)
    for a, b in zip(trng.scatter_draws(kt, bounce),
                    trng.scatter_draws(kt, 6)):
        assert torch.equal(a, b)
