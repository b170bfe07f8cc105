"""The port's threefry keys against ``jax.random`` (threefry2x32 with the
partitionable counter layout, JAX's default): ``split``, ``uniform`` and
``bernoulli`` are bit-exact over 64 seeded keys, with and without
``torch.func.vmap``.

``normal`` goes through the port's copy of XLA's ``erfinv`` polynomial;
its ``log1p`` is PyTorch's, not XLA's, so the two differ by an ulp or two
and normal draws are held to ``rtol=3e-7, atol=1e-8`` instead of bit
equality, over 64 keys x 7 draws and over 2,000 keys x 50 draws.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.mcmc import prng  # noqa: E402

N_KEYS = 64
DIM = 7


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 2**32, size=(N_KEYS, 2), dtype=np.uint64).astype(np.uint32)
    return raw, interop.keys_from_numpy(raw, "cpu")


@pytest.fixture(scope="module")
def jax_draws(keys):
    raw, _ = keys
    k = jax.numpy.asarray(raw)
    return {
        "split3": np.asarray(jax.vmap(lambda x: jax.random.split(x, 3))(k)),
        "split4": np.asarray(jax.vmap(lambda x: jax.random.split(x, 4))(k)),
        "uniform": np.asarray(jax.vmap(lambda x: jax.random.uniform(x))(k)),
        "uniform_vec": np.asarray(jax.vmap(lambda x: jax.random.uniform(x, (DIM,)))(k)),
        "bernoulli": np.asarray(jax.vmap(lambda x: jax.random.bernoulli(x))(k)),
        "normal": np.asarray(jax.vmap(lambda x: jax.random.normal(x, (DIM,)))(k)),
    }


TORCH_FNS = {
    "split3": lambda k: prng.split(k, 3),
    "split4": lambda k: prng.split(k, 4),
    "uniform": prng.uniform,
    "uniform_vec": lambda k: prng.uniform(k, (DIM,)),
    "bernoulli": prng.bernoulli,
    "normal": lambda k: prng.normal(k, (DIM,)),
}


def _as_numpy(name: str, x: torch.Tensor) -> np.ndarray:
    return interop.keys_to_numpy(x) if name.startswith("split") else x.numpy()


@pytest.mark.parametrize("vmapped", [True, False], ids=["vmap", "loop"])
@pytest.mark.parametrize("name", ["split3", "split4", "uniform", "uniform_vec",
                                  "bernoulli"])
def test_bits_equal_jax(keys, jax_draws, name, vmapped):
    _, k = keys
    fn = TORCH_FNS[name]
    got = torch.func.vmap(fn)(k) if vmapped else torch.stack([fn(x) for x in k])
    np.testing.assert_array_equal(_as_numpy(name, got), jax_draws[name])


@pytest.mark.parametrize("vmapped", [True, False], ids=["vmap", "loop"])
def test_normal_matches_jax_to_a_few_ulp(keys, jax_draws, vmapped):
    _, k = keys
    fn = TORCH_FNS["normal"]
    got = torch.func.vmap(fn)(k) if vmapped else torch.stack([fn(x) for x in k])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_draws["normal"], rtol=3e-7, atol=1e-8)


def test_normal_matches_jax_over_100k_draws():
    rng = np.random.default_rng(12)
    raw = rng.integers(0, 2**32, size=(2000, 2), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax.vmap(lambda x: jax.random.normal(x, (50,)))(jax.numpy.asarray(raw)))
    got = torch.func.vmap(lambda x: prng.normal(x, (50,)))(interop.keys_from_numpy(raw, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-7, atol=1e-8)


@pytest.mark.parametrize("draw", ["normal", "uniform"])
def test_bfloat16_draws_equal_jax_bit_for_bit(draw):
    """JAX's bfloat16 draws take 8 random bits, not the float32 draw cast:
    every one of the 128 uniform values appears in 100k draws, and each
    draw equals JAX's."""
    rng = np.random.default_rng(14)
    raw = rng.integers(0, 2**32, size=(2000, 2), dtype=np.uint64).astype(np.uint32)
    jfn = getattr(jax.random, draw)
    want = np.asarray(jax.vmap(lambda x: jfn(x, (50,), jax.numpy.bfloat16))(
        jax.numpy.asarray(raw)).astype(jax.numpy.float32))
    fn = getattr(prng, draw)
    got = torch.func.vmap(lambda x: fn(x, (50,), dtype=torch.bfloat16))(
        interop.keys_from_numpy(raw, "cpu"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert len(np.unique(want)) == 128
    cast = np.asarray(jfn(jax.numpy.asarray(raw[0]), (50,)).astype(jax.numpy.bfloat16)
                      .astype(jax.numpy.float32))
    assert not np.array_equal(got[0].float().numpy(), cast)


def test_erfinv_matches_xla_including_the_ends():
    x = np.concatenate([[-1.0, 1.0, 0.0],
                        np.random.default_rng(13).uniform(-1, 1, 20_000)]).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jax.numpy.asarray(x)))
    got = prng.erfinv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:3], want[:3])  # -inf, inf, 0
    np.testing.assert_allclose(got[3:], want[3:], rtol=3e-7, atol=1e-8)


@pytest.mark.parametrize("seed", [0, 1, 17, 123_456, 2**31 - 1])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(
        interop.keys_to_numpy(prng.prng_key(seed)),
        np.asarray(jax.random.PRNGKey(seed)),
    )


def test_key_round_trip_keeps_bits(keys):
    raw, k = keys
    assert k.dtype == torch.int32
    np.testing.assert_array_equal(interop.keys_to_numpy(k), raw)


def test_draws_copy_nothing_from_the_host(keys):
    """Every draw is made on the key's device: no host tensor is copied in
    (``torch.tensor(..., device=...)`` would be, and a CUDA graph cannot
    capture that copy, so ``local``'s graph segments could not draw)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        seen: set = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    _, k = keys
    with Ops() as mode:
        prng.split(k[0], 3)
        prng.uniform(k[1])
        prng.bernoulli(k[2])
        prng.normal(k[3], (DIM,))
    assert not mode.seen & {"lift_fresh", "lift_fresh_copy"}, mode.seen
