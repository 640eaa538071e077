"""The port's threefry2x32 streams against ``jax.random`` (bit-exact bits,
normals within 1e-6) and the per-utterance NetVLAD weights built on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu.ops import netvlad as jnetvlad
from icassp2022_depression_tpu_torch.ops import netvlad as tnetvlad
from icassp2022_depression_tpu_torch.ops import prng, rnn_cuda


def _bits(key) -> np.ndarray:
    """A JAX uint32 key or bits array as int64 numpy."""
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**32 + 5])
def test_prng_key_exact(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  _bits(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed,data", [(0, 0), (0, 1), (3, 12345),
                                       (9, 2**31 - 1), (1, 2**32 - 1)])
def test_fold_in_exact(seed, data):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    got = prng.fold_in(prng.prng_key(seed), data)
    np.testing.assert_array_equal(got.numpy(), _bits(want))


def test_fold_in_broadcasts_over_data():
    data = [0, 5, 77, 4096]
    got = prng.fold_in(prng.prng_key(2), data)
    want = np.stack([_bits(jax.random.fold_in(jax.random.PRNGKey(2), d))
                     for d in data])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num", [2, 3, 4, 9])
def test_split_exact(num):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 3)
    got = prng.split(prng.fold_in(prng.prng_key(11), 3), num)
    np.testing.assert_array_equal(got.numpy(),
                                  _bits(jax.random.split(key, num)))


@pytest.mark.parametrize("shape", [(1,), (7,), (5, 7), (2, 3, 4)])
def test_random_bits_exact(shape):
    key = jax.random.split(jax.random.PRNGKey(4), 3)[1]
    tkey = prng.split(prng.prng_key(4), 3)[1]
    np.testing.assert_array_equal(prng.random_bits(tkey, shape).numpy(),
                                  _bits(jax.random.bits(key, shape)))


def test_uniform_close():
    """[0, 1) is exact (the mantissa trick); a scaled range may differ by
    an ulp where XLA fuses the scale and shift into one FMA."""
    key = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(
        prng.uniform(prng.prng_key(5), (64, 3)).numpy(),
        np.asarray(jax.random.uniform(key, (64, 3), jnp.float32)))
    got = prng.uniform(prng.prng_key(5), (64, 3), -2.0, 3.0)
    want = np.asarray(jax.random.uniform(key, (64, 3), jnp.float32,
                                         -2.0, 3.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunk", [8, 35, 1 << 22])
def test_random_bits_chunked_exact(chunk, monkeypatch):
    """A draw of more counters than a pass holds runs in slices."""
    monkeypatch.setattr(prng, "_BITS_CHUNK", chunk)
    key = jax.random.split(jax.random.PRNGKey(4), 3)[1]
    tkey = prng.split(prng.prng_key(4), 3)[1]
    np.testing.assert_array_equal(prng.random_bits(tkey, (5, 7)).numpy(),
                                  _bits(jax.random.bits(key, (5, 7))))


@pytest.mark.parametrize("minval,maxval", [(-2.0, 3.0), (-0.125, 0.125),
                                           (-0.0441941738, 0.0441941738)])
def test_scaled_uniform_exact(minval, maxval):
    """Scaled ranges bit for bit: a power-of-two span in float32, any
    other through the float64 multiply-add."""
    key = jax.random.PRNGKey(5)
    got = prng.uniform(prng.prng_key(5), (64, 3), minval, maxval)
    want = jax.random.uniform(key, (64, 3), jnp.float32, minval, maxval)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 8])
def test_normal_close(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 21)
    got = prng.normal(prng.fold_in(prng.prng_key(seed), 21), (4000,))
    want = np.asarray(jax.random.normal(key, (4000,), jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ordinal", [0, 1, 2, 41, 341])
def test_per_utterance_params_close(ordinal):
    want = jnetvlad.per_utterance_params(0, ordinal, 16, 4, 32)
    got = tnetvlad.per_utterance_params(0, ordinal, 16, 4, 32)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)


def test_batched_per_utterance_params_close():
    ordinals = [0, 4, 5, 300]
    want = jnetvlad.batched_per_utterance_params(
        3, jnp.asarray(ordinals), 16, 4, 32)
    got = tnetvlad.batched_per_utterance_params(3, ordinals, 16, 4, 32)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    single = tnetvlad.per_utterance_params(3, 300, 16, 4, 32)
    for k in single:
        assert torch.equal(got[k][3], single[k])


# -- the kernel route's boundaries, on the CPU -------------------------------

#: each public draw, called with a key
DRAWS = {
    "fold_in": lambda key: prng.fold_in(key, [3, 4, 5]),
    "split": lambda key: prng.split(key, 4),
    "random_bits": lambda key: prng.random_bits(key, (5, 7), rows=(2, 9)),
    "uniform": lambda key: prng.uniform(key, (64, 3), -0.3, 0.3),
    "normal": lambda key: prng.normal(key, (40,)),
    "bernoulli": lambda key: prng.bernoulli(key, 0.5, (8, 16), (4, 12)),
}
PLAIN = {
    "fold_in": lambda key: prng.fold_in_torch(key, [3, 4, 5]),
    "split": lambda key: prng.split_torch(key, 4),
    "random_bits": lambda key: prng.random_bits_torch(key, (5, 7),
                                                      rows=(2, 9)),
    "uniform": lambda key: prng.uniform_torch(key, (64, 3), -0.3, 0.3),
    "normal": lambda key: prng.normal_torch(key, (40,)),
    "bernoulli": lambda key: prng.bernoulli_torch(key, 0.5, (8, 16),
                                                  (4, 12)),
}


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_cpu_keys_take_the_plain_route(draw, monkeypatch):
    """A CPU key never reaches the kernel: the draw is its plain version,
    and the threefry counter does not move."""
    def no_kernel():
        raise AssertionError("the kernel route was taken for a CPU key")

    monkeypatch.setattr(prng, "_kernel", no_kernel)
    key = prng.split(prng.prng_key(17), 3)             # [3, 2], CPU
    before = rnn_cuda.launch_counts()["threefry"]
    got = DRAWS[draw](key)
    assert rnn_cuda.launch_counts()["threefry"] == before == prng.LAUNCHES
    want = PLAIN[draw](key)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_threefry_counter_in_launch_counts(monkeypatch):
    """``threefry`` is one of ``rnn_cuda.launch_counts()``'s sources, and
    ``add_launches`` (a CUDA graph's replays) moves it."""
    monkeypatch.setattr(prng, "LAUNCHES", 5)
    counts = rnn_cuda.launch_counts()
    assert counts["threefry"] == 5
    assert set(counts) == set(rnn_cuda.COUNTERS) and "threefry" in counts
    rnn_cuda.add_launches({"threefry": 2, "gru_fwd": 0}, 3)
    assert prng.LAUNCHES == 11
    assert rnn_cuda.launch_counts()["threefry"] == 11


def _noncontiguous_key():
    # [2, 3] transposed: each key's two words 3 elements apart
    return torch.zeros((2, 3), dtype=torch.int64, device="meta").t()


@pytest.mark.parametrize("draw", sorted(DRAWS))
@pytest.mark.parametrize("bad,error,match", [
    (lambda: torch.zeros((3, 2), dtype=torch.int32, device="meta"),
     TypeError, "int64"),
    (_noncontiguous_key, ValueError, "contiguous"),
    (lambda: torch.zeros((3, 2), dtype=torch.int64, device="meta"),
     ValueError, "unsupported device"),
], ids=["dtype", "contiguity", "device"])
def test_kernel_route_argument_checks(draw, bad, error, match):
    """A key off the CPU goes to the kernel, whose wrapper raises on a
    dtype, a layout or a device it does not take (no fallback)."""
    with pytest.raises(error, match=match):
        DRAWS[draw](bad())
