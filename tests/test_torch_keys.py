"""The port's threefry key chain (``repro_torch/core/keys.py``) and its
uniform draw (``ref.threefry_uniform_ref``) against ``jax.random`` and
the JAX package's plain version, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import keys
from repro_torch.kernels import ref

DATA = (0, 1, 7, 35, 0x636D70, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1)
SEEDS = (0, 1, 17, 2**31 - 1, 2**31 + 5, 2**32 - 1)


def _jax_words(key) -> list:
    return np.asarray(jax.random.key_data(key)).astype(np.int64).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_is_jax_prngkey(seed):
    assert keys.PRNGKey(seed).tolist() == _jax_words(jax.random.PRNGKey(seed))


def test_prngkey_refuses_a_seed_outside_32_bits():
    for seed in (-1, 2**32):
        with pytest.raises(ValueError, match="32-bit"):
            keys.PRNGKey(seed)


@pytest.mark.parametrize("seed", (1, 2**31 + 5))
def test_fold_in_is_jax_fold_in_bitwise(seed):
    jkey, tkey = jax.random.PRNGKey(seed), keys.PRNGKey(seed)
    for d in DATA:
        assert keys.fold_in(tkey, d).tolist() == _jax_words(jax.random.fold_in(jkey, d)), d
    # a chain, and many data at once (the round's client fan-out)
    jchain, tchain = jkey, tkey
    for d in DATA:
        jchain, tchain = jax.random.fold_in(jchain, d), keys.fold_in(tchain, d)
    assert tchain.tolist() == _jax_words(jchain)
    many = keys.fold_in(tkey, torch.tensor(DATA))
    assert many.tolist() == [_jax_words(jax.random.fold_in(jkey, d)) for d in DATA]
    assert keys.key_data(tkey) is tkey


@pytest.mark.parametrize("n", [1, 2, 3, 65, 512, 513, 4096, 4097])
def test_threefry_uniform_is_the_jax_plain_version_bitwise(n):
    rng = np.random.default_rng(n)
    kd = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jref.threefry_uniform_ref(jnp.asarray(kd), n))
    got = ref.threefry_uniform_ref(torch.from_numpy(kd.astype(np.int64)), n).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_threefry_uniform_over_every_n_up_to_4097():
    """Every n from 1 to 4097, odd and even, at one key: the draw at
    every position p < n lands where JAX puts it. Both plain versions
    take n as an array here, so one traced JAX call covers a block of n."""
    kd = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    pos = np.arange(4097, dtype=np.uint32)

    @jax.jit
    def jax_block(ns):
        k0, k1 = jnp.uint32(kd[0]), jnp.uint32(kd[1])
        return jax.vmap(lambda n: jref.bits_to_uniform(
            jref.threefry_random_bits_at(k0, k1, jnp.asarray(pos), n)))(ns)

    tk0, tk1 = int(kd[0]), int(kd[1])
    tpos = torch.from_numpy(pos.astype(np.int64))[None, :]
    for start in range(1, 4098, 512):
        ns = np.arange(start, min(start + 512, 4098), dtype=np.uint32)
        want = np.asarray(jax_block(jnp.asarray(ns))).view(np.uint32)
        got = ref.bits_to_uniform(ref.threefry_random_bits_at(
            tk0, tk1, tpos, torch.from_numpy(ns.astype(np.int64))[:, None])).numpy()
        valid = pos[None, :] < ns[:, None]
        np.testing.assert_array_equal(got.view(np.uint32)[valid], want[valid])
        for n in (ns[0], ns[-1]):  # the entry point with an int n, at the block's ends
            row = ref.threefry_uniform_ref(torch.from_numpy(kd.astype(np.int64)), int(n))
            np.testing.assert_array_equal(row.numpy().view(np.uint32),
                                          want[n - ns[0], :n])


def test_threefry_uniform_takes_a_client_axis():
    kd = torch.tensor([[1, 2], [2**32 - 1, 5], [7, 2**31]])
    rows = ref.threefry_uniform_ref(kd, 33)
    assert rows.shape == (3, 33)
    for k in range(3):
        assert torch.equal(rows[k], ref.threefry_uniform_ref(kd[k], 33))


@pytest.fixture
def non_partitionable():
    """jax.random with the non-partitionable threefry (the pinned jax's
    default; F2a), restored after the test."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)


@pytest.mark.parametrize("n", [1, 2, 65, 513, 4096, 4097])
def test_threefry_uniform_is_jax_random_uniform(non_partitionable, n):
    for seed, data in ((0, 0), (42, 2**31 + 3)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        want = np.asarray(jax.random.uniform(jkey, (n,)))
        tkey = keys.fold_in(keys.PRNGKey(seed), data)
        got = ref.threefry_uniform_ref(tkey, n).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# split, uniform and normal follow the non-partitionable threefry: each
# test below sets the flag through the ``non_partitionable`` fixture.
# normal restates XLA's float32 erf_inv operation by operation: jax 0.9.0's
# CPU bits exactly (tests/test_torch_threefry_normal.py holds it on every value)
NORMAL_RTOL = NORMAL_ATOL = 0.0


def _jax_key(seed, data):
    return jax.random.fold_in(jax.random.PRNGKey(seed), data)


def _port_key(seed, data):
    return keys.fold_in(keys.PRNGKey(seed), data)


@pytest.mark.parametrize("n", [1, 2, 3, 35])
def test_split_is_jax_split_bitwise(non_partitionable, n):
    for seed, data in ((0, 0), (42, 2**31 + 3), (7, 0x616767)):
        want = _jax_words(jax.random.split(_jax_key(seed, data), n))
        assert keys.split(_port_key(seed, data), n).tolist() == want
    # many keys at once: the clients' keys (K, 2) -> (K, n, 2)
    ckeys = keys.fold_in(_port_key(1, 2), torch.arange(4))
    many = keys.split(ckeys, n)
    assert many.shape == (4, n, 2)
    for k in range(4):
        want = jax.random.split(jax.random.fold_in(_jax_key(1, 2), k), n)
        assert many[k].tolist() == _jax_words(want)


def test_split_depends_on_the_partitionable_flag(non_partitionable):
    """The guard: jax's other threefry gives other keys, so a test that
    forgot the flag would see it."""
    ours = keys.split(_port_key(3, 4), 3).tolist()
    assert ours == _jax_words(jax.random.split(_jax_key(3, 4), 3))
    jax.config.update("jax_threefry_partitionable", True)
    assert ours != _jax_words(jax.random.split(_jax_key(3, 4), 3))


@pytest.mark.parametrize("shape", [(1,), (4,), (3, 5), (2, 65, 3)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-2.5, 3.0), (keys._NORMAL_LO, 1.0)])
def test_uniform_is_jax_uniform_bitwise(non_partitionable, shape, bounds):
    lo, hi = bounds
    want = np.asarray(jax.random.uniform(_jax_key(5, 6), shape, minval=lo, maxval=hi))
    got = keys.uniform(_port_key(5, 6), shape, lo, hi)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_uniform_takes_many_keys(non_partitionable):
    ckeys = keys.fold_in(_port_key(8, 9), torch.arange(3))
    got = keys.uniform(ckeys, (5,))
    for k in range(3):
        want = np.asarray(jax.random.uniform(jax.random.fold_in(_jax_key(8, 9), k), (5,)))
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", [(1,), (4,), (5,), (64, 513)])
def test_normal_is_jax_normal_within_tolerance(non_partitionable, shape):
    for seed, data in ((0, 1), (42, 2**31 + 3)):
        want = np.asarray(jax.random.normal(_jax_key(seed, data), shape))
        got = keys.normal(_port_key(seed, data), shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), want, rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


# randint and SpecAugment (the client step's draws): bitwise to JAX
RANDINT_BOUNDS = [(0, 1), (0, 2), (0, 4), (0, 28), (0, 7), (3, 11), (-5, 5), (0, 1000),
                  (7, 7), (9, 2), (0, 2**31 - 1), (-(2**31), 2**31 - 1), (-3, 2**30 + 10)]


@pytest.mark.parametrize("bounds", RANDINT_BOUNDS)
def test_randint_is_jax_randint_bitwise(non_partitionable, bounds):
    lo, hi = bounds
    for seed, data in ((0, 0), (42, 2**31 + 3), (7, 0x616767), (1, 5)):
        want = int(jax.random.randint(_jax_key(seed, data), (), lo, hi))
        assert keys.randint(_port_key(seed, data), lo, hi) == want, (seed, data)


def test_randint_refuses_many_keys():
    with pytest.raises(ValueError, match="one key"):
        keys.randint(keys.fold_in(_port_key(1, 2), torch.arange(3)), 0, 4)


def test_scalar_fast_path_is_the_tensor_path():
    """One key on the CPU is hashed with Python integers; the batched
    tensor path gives the same words."""
    key = _port_key(11, 12)
    many = key[None].expand(2, 2)
    assert keys.fold_in(key, 2**31 + 9).tolist() == keys.fold_in(many, 2**31 + 9)[0].tolist()
    assert keys.split(key, 5).tolist() == keys.split(many, 5)[0].tolist()


SPECAUG_CFGS = [dict(), dict(freq_masks=1, freq_mask_width=3, time_masks=1,
                             time_mask_frac=0.05),
                dict(freq_masks=3, freq_mask_width=40, time_masks=4, time_mask_frac=0.2),
                dict(freq_masks=0, time_masks=2), dict(enabled=False)]


@pytest.mark.parametrize("cfg", SPECAUG_CFGS, ids=str)
@pytest.mark.parametrize("shape", [(2, 24, 16), (3, 128, 80), (1, 5, 4)])
def test_spec_augment_masks_are_jax_bitwise(non_partitionable, cfg, shape):
    from repro.asr.specaugment import SpecAugmentConfig as JaxSpecAug
    from repro.asr.specaugment import spec_augment as jax_spec_augment
    from repro_torch.asr.specaugment import SpecAugmentConfig, spec_augment

    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) + 3.0
    for seed, data in ((0, 1), (5, 2**31 + 7), (9, 123)):
        want = np.asarray(jax_spec_augment(_jax_key(seed, data), jnp.asarray(x),
                                           JaxSpecAug(**cfg)))
        got = spec_augment(_port_key(seed, data), torch.from_numpy(x),
                           SpecAugmentConfig(**cfg)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
