"""The port's adversaries (``repro_torch/core/corruption.py``) against
the JAX package's ``repro/core/corruption.py`` on the same deltas,
reporting masks and keys: the corrupted-client mask and the sign-flip,
zero and stale planes bit for bit (the stale cache across two rounds),
the gaussian plane to ``normal``'s tolerance (rtol and atol 1e-5 on noise
scaled by each leaf's RMS, which sums squares in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import corruption as jcor
from repro_torch.convert import params_from_jax
from repro_torch.core import corruption as tcor
from repro_torch.core import keys

K = 4
GAUSS_TOL = 1e-5


@pytest.fixture
def non_partitionable():
    """jax.random with the non-partitionable threefry (the pinned jax's
    default), restored after the test: the adversary splits its key."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _tree(rng):
    def arr(*shape):
        return (rng.standard_normal((K,) + shape) * 1e-2).astype(np.float32)

    return {"pred_embed": arr(6, 4), "joint_out": arr(5, 7),
            "encoder": [{"w_ih": arr(3, 8), "b": arr(8)} for _ in range(11)]}


def _keys(seed, data):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), data),
            keys.fold_in(keys.PRNGKey(seed), data))


def _same(got: dict, want_tree, tol=None):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        if tol is None:
            np.testing.assert_array_equal(g.numpy().view(np.uint32), w.numpy().view(np.uint32),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol, atol=tol, err_msg=name)


PMASKS = ([1, 1, 1, 1], [1, 0, 1, 0])


@pytest.mark.parametrize("kind", ["sign_flip", "zero", "gaussian"])
@pytest.mark.parametrize("rate,scale", [(0.5, 3.0), (1.0, 1.0), (0.0, 2.0)])
@pytest.mark.parametrize("pmask", PMASKS, ids=("all", "two"))
def test_delta_corruptions_match_jax(non_partitionable, kind, rate, scale, pmask):
    """A dropped client is never corrupted (cmask = drawn * pmask)."""
    deltas = _tree(np.random.default_rng(1))
    pm = np.asarray(pmask, np.float32)
    jfn, tfn = jcor.make_corruption_fn(kind, rate, scale), tcor.make_corruption_fn(kind, rate,
                                                                                   scale)
    for data in range(3):
        jkey, tkey = _keys(2, data)
        jout, jc, _ = jfn(jkey, jax.tree.map(jnp.asarray, deltas), jnp.asarray(pm), None)
        tout, tc, stale = tfn(tkey, params_from_jax(deltas), torch.from_numpy(pm), None)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert stale is None and (tc <= torch.from_numpy(pm)).all()
        _same(tout, jout, GAUSS_TOL if kind == "gaussian" else None)


def test_the_stale_cache_across_two_rounds_matches_jax(non_partitionable):
    """Round 1 replays zeros and caches the participants' honest deltas;
    round 2 replays scale times them, and the cache keeps tracking the
    honest stream (never the replay); a dropped client keeps its entry."""
    rng = np.random.default_rng(3)
    jfn, tfn = jcor.make_corruption_fn("stale", 0.6, 2.0), tcor.make_corruption_fn("stale",
                                                                                   0.6, 2.0)
    jstale = jax.tree.map(lambda a: jnp.zeros_like(jnp.asarray(a)), _tree(rng))
    tstale = params_from_jax(jax.tree.map(np.asarray, jstale))
    corrupted = 0.0
    for r, pmask in enumerate(([1, 1, 0, 1], [1, 0, 1, 1], [1, 1, 1, 1])):
        deltas, pm = _tree(rng), np.asarray(pmask, np.float32)
        jkey, tkey = _keys(4, r)
        jout, jc, jstale = jfn(jkey, jax.tree.map(jnp.asarray, deltas), jnp.asarray(pm), jstale)
        tout, tc, tstale = tfn(tkey, params_from_jax(deltas), torch.from_numpy(pm), tstale)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        _same(tout, jout)
        _same(tstale, jstale)
        corrupted += float(tc.sum())
    assert corrupted > 0


def test_stale_without_a_cache_raises():
    with pytest.raises(ValueError, match="ServerState.stale"):
        tcor.make_corruption_fn("stale", 1.0, 1.0)(keys.PRNGKey(0),
                                                   params_from_jax(_tree(np.random.default_rng(0))),
                                                   torch.ones(K), None)


@pytest.mark.parametrize("kind", ["none", "label_shuffle"])
def test_the_honest_plane_draws_nothing(kind):
    deltas = params_from_jax(_tree(np.random.default_rng(5)))
    fn = tcor.make_corruption_fn(kind, 0.9, 5.0)
    out, cmask, stale = fn(keys.PRNGKey(0), deltas, torch.ones(K), None)
    assert fn is tcor.identity_corruption and out is deltas and stale is None
    assert cmask.tolist() == [0.0] * K


def test_config_and_registry_are_the_references():
    assert tcor.KINDS == jcor.KINDS and tcor.DELTA_KINDS == jcor.DELTA_KINDS
    assert tcor.available_corruptions() == jcor.available_corruptions()
    for kw in (dict(kind="flip"), dict(kind="gaussian", rate=1.5)):
        with pytest.raises(ValueError):
            tcor.CorruptionConfig(**kw)
    assert tcor.CorruptionConfig("sign_flip", 0.25, 3.0) == tcor.CorruptionConfig(
        kind="sign_flip", rate=0.25, scale=3.0)
