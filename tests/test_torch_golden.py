"""The port's per-ray radiance against rrt_tpu's golden oracle.

rrt_tpu/golden.py's trace_ray is a scalar float64 transcription of the
books' recursive tracer; extract_draws gives it the random draws every
driver consumes for a ray's (seed, pixel, sample) keys. The port's batch
driver (trace_batch, on the CPU through the intersect kernel's plain
version) traces the same camera rays with the same keys. The rule is
tests/test_golden.py's: a ray matches when every channel is within
2e-3 + 1% of the golden's, and 99% of rays must match (an f32 decision
near an argmin tie or a dielectric threshold flips a whole path). Of
these 128 rays, 1% is 1.3: rrt_tpu's own batch driver parts from the
golden on 2 of the 128 book2chap2 rays (rays 61 and 89, measured), so
at most 2 may part. book2chap2's golden moves each sphere to the ray's
time as the port does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu import golden
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu_torch import render, rng
from rrt_tpu_torch import scenes as tscenes

W, H, MAX_DEPTH = 16, 8, 8


@pytest.mark.parametrize("name", ["chap12", "book2chap2"])
def test_batch_radiance_matches_golden(name):
    n = W * H
    ids = torch.arange(n)
    px, py = ids % W, ids // W
    keys = rng.sample_keys(rng.key_words(7), py * W + px, 0)
    j_keys = jrng.sample_keys(jax.random.key(7),
                              jnp.asarray((py * W + px).numpy(), jnp.uint32),
                              0)
    np.testing.assert_array_equal(
        rng.u32_bits(keys).numpy().view(np.uint32), np.asarray(j_keys))
    scene, cam = tscenes.SCENES[name](W, H)
    o, d, tm = render.generate_rays(cam, px, py, W, H, keys)
    rad, _ = render.trace_batch(scene, o, d, tm, keys, MAX_DEPTH, 1e-3)
    radiance = rad.T.numpy()

    j_scene, _ = jscenes.SCENES[name](W, H)
    gs = golden.GoldenScene(j_scene)
    draws = golden.extract_draws(j_keys, j_scene.n_media, MAX_DEPTH)
    o_np, d_np = o.T.numpy(), d.T.numpy()
    expected = np.stack([
        golden.trace_ray(gs, o_np[i], d_np[i], float(tm[i]), i, draws,
                         MAX_DEPTH) for i in range(n)])
    if name == "book2chap2":
        assert float(tm.min()) < 0.2 and float(tm.max()) > 0.8
    close = np.all(np.abs(radiance - expected)
                   <= 2e-3 + 1e-2 * np.abs(expected), axis=-1)
    assert (~close).sum() <= 2, (np.where(~close)[0],
                                 np.abs(radiance - expected).max())
    assert (expected.max(axis=-1) > 0).mean() > 0.9
