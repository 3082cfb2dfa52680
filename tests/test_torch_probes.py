"""The probes (rrt_tpu_torch/probes) against rrt_tpu's
benchmarks/probe_row_layout.py, probe_rng.py and probe_reshape.py.

Each JAX probe is loaded from its file as it stands, with its Pallas
kernel in interpret mode and its ITERS cut to 8 (its functions read the
module's ITERS when they trace). The port's wrappers run their plain
versions on the CPU. Inputs come from a seed. Rules: the u32 mixers bit
for bit. The f32 chains start from values between 1e-8 and 1e-6, where
the addend 1e-9 moves every element by at least 12% in 128 steps (from
values near 1 the chain moves them by only 1.5e-5 relative, so a chain
that did nothing would pass a relative test of the values). What is
held is each element's increment, out - x, within 1e-4 relative of the
JAX probe's. The plain version rounds once a step, as the kernel's fmaf
does; XLA on the CPU contracts the probe's x * a + b the same way and
the increments are equal (measured); two roundings a step would put
them 3.95e-5 apart at (8, 1024) (measured). tests/test_torch_cuda.py holds the
kernel bit for bit to the plain version."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rrt_tpu_torch.probes import probe_reshape, probe_rng, probe_row_layout

ITERS = 8
_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")


@pytest.fixture
def load_probe(monkeypatch):
    """Load benchmarks/<name>.py with ITERS = 8 and Pallas in interpret
    mode. Importing a probe calls enable_persistent_cache(), which sets
    jax_compilation_cache_dir for the whole worker process, and may set
    JAX_COMPILATION_CACHE_DIR: both are put back afterwards."""
    old_dir = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       os.environ.get("JAX_COMPILATION_CACHE_DIR", ""))
    if not os.environ["JAX_COMPILATION_CACHE_DIR"]:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"_jax_{name}", os.path.join(_BENCH, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        monkeypatch.setattr(mod, "ITERS", ITERS)
        return mod

    yield load
    jax.config.update("jax_compilation_cache_dir", old_dir)


def _f32(shape, seed):
    return (10.0 ** np.random.default_rng(seed).uniform(-8.0, -6.0, shape)
            ).astype(np.float32)


def _assert_increments_close(out, ref, x):
    assert np.all(np.abs(ref - x) >= 0.1 * x)  # the chain moved x
    np.testing.assert_allclose(out - x, ref - x, rtol=1e-4, atol=0)


@pytest.mark.parametrize("shape", probe_row_layout.SHAPES)
def test_row_layout_matches_reference(load_probe, shape):
    mod = load_probe("probe_row_layout")
    x = _f32(shape, 0)
    ref = np.asarray(mod.make_fn(shape)(x))
    before = probe_row_layout.fma_chain.launches
    out = probe_row_layout.fma_chain(torch.from_numpy(x), iters=ITERS)
    assert probe_row_layout.fma_chain.launches == before  # plain version
    assert out.shape == shape
    _assert_increments_close(out.numpy(), ref, x)


@pytest.mark.parametrize("mode", ["flat", "reshape"])
def test_reshape_matches_reference(load_probe, mode):
    mod = load_probe("probe_reshape")
    x = _f32((1, 1024), 1)
    ref = np.asarray(mod.make_fn(mode)(x))
    fn = (probe_row_layout.fma_chain if mode == "flat"
          else probe_reshape.fma_chain_relayout)
    out = fn(torch.from_numpy(x), iters=ITERS)
    _assert_increments_close(out.numpy(), ref, x)


@pytest.mark.parametrize("sign", [1.0, -1.0, 0.0])
def test_fmaf_rounds_once(sign):
    """(1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 lies halfway between two
    float32 values, and an addend of +-2^-80 decides the rounding. A sum
    rounded to float64 first loses the addend and rounds the tie to
    even; fmaf (and the plain version) round the exact value once."""
    x = torch.tensor([1 + 2**-12], dtype=torch.float32)
    want = {1.0: 1 + 2**-11 + 2**-23, -1.0: 1 + 2**-11, 0.0: 1 + 2**-11}
    out = probe_row_layout.fmaf(x, 1 + 2**-12, sign * 2**-80)
    assert out.dtype == torch.float32 and out.item() == want[sign]


@pytest.mark.parametrize("mode", probe_rng.MODES)
def test_rng_matches_reference_bit_for_bit(load_probe, mode):
    mod = load_probe("probe_rng")
    x = np.random.default_rng(2).integers(0, 2**32, (1, 1024),
                                          dtype=np.uint32)
    ref = np.asarray(mod.make_fn(mode)(x))
    out = probe_rng.mix(torch.from_numpy(x.view(np.int32)), mode=mode,
                        iters=ITERS)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)


def test_probes_check_their_inputs():
    with pytest.raises(ValueError):
        probe_reshape.fma_chain_relayout(torch.zeros(1000), iters=1)
    with pytest.raises(ValueError):
        probe_rng.mix(torch.zeros(8, dtype=torch.int32), mode="xorshift",
                      iters=1)
    with pytest.raises(ValueError):
        probe_row_layout.fma_chain(torch.zeros(8, dtype=torch.float64),
                                   iters=1)


def test_mains_need_a_card(monkeypatch, capsys):
    """Without a CUDA device a probe prints why and returns non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (probe_row_layout, probe_rng, probe_reshape):
        assert mod.main() == 2
    assert "is_available() is False" in capsys.readouterr().err
