"""The port's aggregators (``repro_torch/core/aggregation.py``) against
the JAX package's ``repro/core/aggregation.py`` on the same stacked
deltas, example counts, reporting masks and keys, with NaN, infinities
and ties among the deltas. The robust rules' choices (ranks, trims,
medians) are exact; their means divide sums of at most K fp32 values,
which JAX may add in another order (or fuse into multiply-adds): rtol
AGG_RTOL, and AGG_ATOL where the terms cancel. clipped_mean's norms
sum thousands of squares in another order, and its noise is ``normal``:
rtol and atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro_torch.convert import params_from_jax
from repro_torch.core import aggregation as tagg
from repro_torch.core import keys

K = 5
AGG_RTOL = 1e-6  # a sum of at most K fp32 terms, possibly in another order
AGG_ATOL = 1e-7  # a few ulps of the terms (|delta| < 1) where the sum cancels
DP_TOL = 1e-5    # norms over every leaf, and the noise's normal draw


@pytest.fixture
def non_partitionable():
    """jax.random with the non-partitionable threefry (the pinned jax's
    default), restored after the test: clipped_mean splits its key."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _deltas(seed: int, hostile: bool = True):
    """K-stacked deltas in a model-like tree (dicts out of key order, a
    list of 11 layers), with ties from a coarse grid, and (hostile) NaN
    and infinite coordinates in some clients."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        a = np.round(rng.standard_normal((K,) + shape) * 4.0) / 64.0  # many ties
        return a.astype(np.float32)

    tree = {"pred_embed": arr(6, 4), "joint_out": arr(5, 7),
            "encoder": [{"w_ih": arr(3, 8), "b": arr(8)} for _ in range(11)],
            "joint_bias": arr(7)}
    if hostile:
        tree["joint_out"][1, 0, :3] = np.nan
        tree["joint_out"][3, 2, 1] = np.inf
        tree["encoder"][4]["b"][2, :] = -np.inf
        tree["pred_embed"][0] = tree["pred_embed"][2]  # two clients tie everywhere
    return tree


def _inputs(seed: int, pmask, hostile=True):
    tree = _deltas(seed, hostile)
    n_k = np.array([4.0, 2.0, 3.0, 1.0, 5.0], np.float32) * np.asarray(pmask, np.float32)
    jx = (jax.tree.map(jnp.asarray, tree), jnp.asarray(n_k), jnp.asarray(pmask, jnp.float32))
    tx = (params_from_jax(tree), torch.from_numpy(n_k), torch.tensor(pmask, dtype=torch.float32))
    return jx, tx


PMASKS = {"all": [1, 1, 1, 1, 1], "three": [1, 0, 1, 1, 0], "one": [0, 0, 1, 0, 0]}


def _check(got: dict, want_tree, rtol, atol=0.0):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


ROBUST = [("trimmed_mean", 0.0), ("trimmed_mean", 0.2), ("trimmed_mean", 0.4),
          ("trimmed_mean", 0.6), ("coordinate_median", 0.1)]


@pytest.mark.parametrize("name,trim", ROBUST)
@pytest.mark.parametrize("cohort", list(PMASKS))
def test_robust_rules_match_jax(name, trim, cohort):
    """NaN and infinite coordinates are excluded per coordinate, ties get
    distinct ranks, and a trim past one half still keeps a client."""
    jx, tx = _inputs(1, PMASKS[cohort])
    hyp = dict(jagg.AGG_HYPER_DEFAULTS, trim_frac=trim)
    want = jagg.get_aggregator(name)(*jx, hyp, None)
    got = tagg.get_aggregator(name)(*tx, hyp, None)
    _check(got, want, AGG_RTOL, AGG_ATOL)
    assert all(bool(torch.isfinite(v).all()) for v in got.values())


def test_ranks_are_stable_on_ties():
    """Equal values rank in client order, non-contributors last."""
    flat = torch.tensor([[1.0, 2.0], [1.0, np.nan], [0.5, 2.0], [1.0, 2.0]])
    ok = tagg._contributors(flat, torch.tensor([1.0, 1.0, 1.0, 0.0]))
    ranks = tagg._contributor_ranks(flat, ok)
    want = jagg._contributor_ranks(jnp.asarray(flat.numpy()), jnp.asarray(ok.numpy()))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(want))
    assert ranks[:, 0].tolist() == [1.0, 2.0, 0.0, 3.0]


@pytest.mark.parametrize("cohort", list(PMASKS))
def test_weighted_mean_matches_jax(cohort):
    """The paper's rule has no defence: it is held on finite deltas."""
    jx, tx = _inputs(2, PMASKS[cohort], hostile=False)
    want = jagg.weighted_mean(*jx, jagg.AGG_HYPER_DEFAULTS, None)
    _check(tagg.weighted_mean(*tx, tagg.AGG_HYPER_DEFAULTS, None), want, AGG_RTOL, AGG_ATOL)


@pytest.mark.parametrize("cohort", list(PMASKS))
@pytest.mark.parametrize("clip,sigma", [(1.0, 0.0), (0.05, 0.0), (0.5, 0.3)])
def test_clipped_mean_matches_jax(non_partitionable, cohort, clip, sigma):
    """A client with a non-finite coordinate gets weight 0; the noise of
    leaf i comes from split(key, L)[i] in JAX's tree order."""
    jx, tx = _inputs(3, PMASKS[cohort])
    hyp = dict(jagg.AGG_HYPER_DEFAULTS, dp_clip=clip, dp_sigma=sigma)
    jkey = jax.random.fold_in(jax.random.PRNGKey(4), 0x616767)
    tkey = keys.fold_in(keys.PRNGKey(4), 0x616767)
    want = jagg.clipped_mean(*jx, hyp, jkey)
    got = tagg.clipped_mean(*tx, hyp, tkey)
    _check(got, want, DP_TOL, DP_TOL)
    assert all(bool(torch.isfinite(v).all()) for v in got.values())


def test_the_registry_is_the_references():
    assert tagg.available_aggregators() == jagg.available_aggregators()
    assert tagg.AGG_HYPER_DEFAULTS == jagg.AGG_HYPER_DEFAULTS
    with pytest.raises(KeyError, match="unknown aggregator"):
        tagg.get_aggregator("mean")
