"""The port's compression plane (``repro_torch/core/compression.py``)
against the JAX package's: exact wire bytes, the tree's leaf order, and
the code-domain fast path on the same numpy deltas, client weights and
keys (bitwise for the intN planes, rtol 1e-6 for top-k)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.models import rnnt as jrnnt
from repro_torch.configs import rnnt_librispeech
from repro_torch.convert import params_from_jax
from repro_torch.core import compression as tcomp
from repro_torch.core import keys
from repro_torch.core.task import get_task

K = 3
TOPK_RTOL = 1e-6  # fp32 scatter sums of at most K values in the same order (bitwise expected)

CONFIGS = [
    dict(kind="none"),
    dict(kind="int8"),
    dict(kind="int8", stochastic=False),
    dict(kind="int4"),
    dict(kind="int4", packed=True),
    dict(kind="int4", packed=True, stochastic=False),
    dict(kind="int4", packed=True, error_feedback=True),
    dict(kind="topk", topk_frac=0.05),
    dict(kind="topk", topk_frac=0.25, error_feedback=True),
    dict(kind="topk", topk_frac=1.0),
]


def _pair(**kw):
    return jcomp.CompressionConfig(**kw), tcomp.CompressionConfig(**kw)


def _tiny_jax_shapes():
    tcfg = get_task("asr-rnnt").config
    jcfg = jrnnt.RNNTConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                               if f.name != "specaug"})
    return jax.eval_shape(lambda: jrnnt.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_wire_bytes_match_jax_exactly_at_the_tiny_config(kw):
    jcfg, tcfg = _pair(**kw)
    jtree = _tiny_jax_shapes()
    params = dict(get_task("asr-rnnt").model.named_parameters())  # meta tensors: shapes only
    assert tcomp.client_wire_bytes(tcfg, params) == jcomp.client_wire_bytes(jcfg, jtree)
    assert tcomp.tree_param_bytes(params) == jcomp.tree_param_bytes(jtree)
    assert tcomp.wire_cost_profile(tcfg, params) == jcomp.wire_cost_profile(jcfg, jtree)


def test_wire_bytes_at_rnnt_librispeech_from_its_shapes():
    """The paper-width model's 35 tensors, from the meta-device template:
    each kind's bytes equal JAX's formula over the same shapes, and the
    per-client uplink is what chip_smoke.py holds the card's run to."""
    params = dict(get_task(rnnt_librispeech.ARCH_ID).model.named_parameters())
    assert len(params) == 35 and sum(p.numel() for p in params.values()) == 105_333_760
    assert max(p.numel() for p in params.values()) == 1152 * 4608
    shapes = {k: jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32) for k, p in params.items()}
    want = {"none": 421_335_040, "int8": 105_333_900, "int4": 52_667_020, "topk": 42_133_592}
    for kind, up in want.items():
        jcfg, tcfg = _pair(kind=kind, topk_frac=0.05)
        assert tcomp.client_wire_bytes(tcfg, params) == up
        assert jcomp.client_wire_bytes(jcfg, shapes) == up
        assert tcomp.leaf_wire_bytes(tcfg, 5) == jcomp.leaf_wire_bytes(jcfg, 5)


def _nested_tree(rng, lead=()):
    """A tree shaped like a model's: dicts out of key order and a list of
    11 layers (so that "10" sorts after "2" only as a number)."""
    def arr(*shape):
        return rng.standard_normal(lead + shape).astype(np.float32) * 0.01

    return {
        "pred_embed": arr(6, 4),
        "joint_out": arr(5, 7),
        "encoder": [{"w_ih": arr(3, 8), "b": arr(8,)} for _ in range(11)],
        "joint_bias": arr(7),
        "predictor": [{"w_ih": arr(4, 8), "b": arr(8,)}],
    }


def test_jax_leaf_order_is_tree_flatten_order():
    tree = _nested_tree(np.random.default_rng(0))
    port = params_from_jax(tree)
    leaves = jax.tree_util.tree_leaves(tree)
    order = tcomp.jax_leaf_order(port)
    assert len(order) == len(leaves)
    for name, leaf in zip(order, leaves):
        assert np.array_equal(port[name].numpy(), leaf), name
    assert list(port) != order  # the dict's own order is not JAX's
    assert order.index("encoder.2.b") < order.index("encoder.10.b")
    # the paper-width model: its names in JAX's order
    names = [n for n, _ in get_task(rnnt_librispeech.ARCH_ID).model.named_parameters()]
    order = tcomp.jax_leaf_order(names)
    assert order[:4] == ["encoder.0.b", "encoder.0.w_hh", "encoder.0.w_ih", "encoder.1.b"]
    assert order.index("encoder.7.w_ih") < order.index("joint_bias") < order.index("pred_embed")
    assert order[-4:] == ["predictor.0.w_ih", "predictor.1.b", "predictor.1.w_hh",
                          "predictor.1.w_ih"]


def _round_inputs(seed: int, pmask=None):
    """The same K-stacked deltas, residuals, example counts, reporting
    mask and client keys for both packages."""
    rng = np.random.default_rng(seed)
    deltas = _nested_tree(rng, lead=(K,))
    ef = _nested_tree(rng, lead=(K,))
    n_k = np.array([4.0, 2.0, 3.0], np.float32)
    pm = np.ones(K, np.float32) if pmask is None else np.asarray(pmask, np.float32)
    n_k = n_k * pm
    base = 7 + seed
    jq = jax.random.fold_in(jax.random.PRNGKey(base), 0x636D70)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jq, i))(jnp.arange(K))
    tq = keys.fold_in(keys.PRNGKey(base), 0x636D70)
    tkeys = keys.fold_in(tq, torch.arange(K))
    assert tkeys.tolist() == np.asarray(jkeys).astype(np.int64).tolist()
    jx = dict(deltas=jax.tree.map(jnp.asarray, deltas), ef=jax.tree.map(jnp.asarray, ef),
              n_k=jnp.asarray(n_k), pmask=jnp.asarray(pm), ckeys=jkeys)
    tx = dict(deltas=params_from_jax(deltas), ef=params_from_jax(ef),
              n_k=torch.from_numpy(n_k), pmask=torch.from_numpy(pm), ckeys=tkeys)
    return jx, tx


def _bitwise(got: dict, want_tree):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w.numpy().view(np.uint32),
                                      err_msg=name)


INTN = [dict(kind="int8"), dict(kind="int8", stochastic=False), dict(kind="int4"),
        dict(kind="int4", packed=True), dict(kind="int4", packed=True, stochastic=False)]


@pytest.mark.parametrize("kw", INTN, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_code_domain_aggregate_is_jax_bitwise(kw):
    jcfg, tcfg = _pair(**kw)
    jx, tx = _round_inputs(1)
    want = jcomp.code_domain_aggregate(jcfg, jx["deltas"], jx["n_k"], jx["pmask"], jx["ckeys"])
    got = tcomp.code_domain_aggregate(tcfg, tx["deltas"], tx["n_k"], tx["pmask"], tx["ckeys"])
    _bitwise(got, want)


@pytest.mark.parametrize("kw", INTN, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_code_domain_aggregate_ef_is_jax_bitwise(kw):
    jcfg, tcfg = _pair(**kw, error_feedback=True)
    jx, tx = _round_inputs(2)
    wbar, ef = jcomp.code_domain_aggregate_ef(jcfg, jx["deltas"], jx["n_k"], jx["pmask"],
                                              jx["ckeys"], jx["ef"])
    got_wbar, got_ef = tcomp.code_domain_aggregate_ef(tcfg, tx["deltas"], tx["n_k"],
                                                      tx["pmask"], tx["ckeys"], tx["ef"])
    _bitwise(got_wbar, wbar)
    _bitwise(got_ef, ef)


def _close(got: dict, want_tree):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=TOPK_RTOL, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("frac", (0.05, 0.25, 1.0))
def test_topk_code_domain_aggregate_matches_jax(frac):
    jcfg, tcfg = _pair(kind="topk", topk_frac=frac)
    jx, tx = _round_inputs(3)
    want = jcomp.code_domain_aggregate(jcfg, jx["deltas"], jx["n_k"], jx["pmask"], jx["ckeys"])
    _close(tcomp.code_domain_aggregate(tcfg, tx["deltas"], tx["n_k"], tx["pmask"], tx["ckeys"]),
           want)
    jcfg, tcfg = _pair(kind="topk", topk_frac=frac, error_feedback=True)
    wbar, ef = jcomp.code_domain_aggregate_ef(jcfg, jx["deltas"], jx["n_k"], jx["pmask"],
                                              jx["ckeys"], jx["ef"])
    got_wbar, got_ef = tcomp.code_domain_aggregate_ef(tcfg, tx["deltas"], tx["n_k"],
                                                      tx["pmask"], tx["ckeys"], tx["ef"])
    _close(got_wbar, wbar)
    _close(got_ef, ef)


@pytest.mark.parametrize("kind", ("int4", "topk"))
def test_a_client_that_does_not_report_keeps_its_residual(kind):
    jcfg, tcfg = _pair(kind=kind, packed=kind == "int4", topk_frac=0.25, error_feedback=True)
    jx, tx = _round_inputs(4, pmask=[1.0, 0.0, 1.0])
    wbar, ef = jcomp.code_domain_aggregate_ef(jcfg, jx["deltas"], jx["n_k"], jx["pmask"],
                                              jx["ckeys"], jx["ef"])
    got_wbar, got_ef = tcomp.code_domain_aggregate_ef(tcfg, tx["deltas"], tx["n_k"],
                                                      tx["pmask"], tx["ckeys"], tx["ef"])
    (_bitwise if kind == "int4" else _close)(got_wbar, wbar)
    (_bitwise if kind == "int4" else _close)(got_ef, ef)
    for name, e in got_ef.items():
        assert torch.equal(e[1], tx["ef"][name][1]), name
        assert not torch.equal(e[0], tx["ef"][name][0]), name


def test_folding_the_leaf_index_in_the_dicts_own_order_changes_the_codes(monkeypatch):
    """The leaf-order hazard: the rounding key of leaf i folds i in JAX's
    tree order. Numbered in the port's dict order instead, the same
    deltas give other codes, and the aggregate departs from JAX's."""
    jcfg, tcfg = _pair(kind="int4", packed=True)
    jx, tx = _round_inputs(5)
    want = jcomp.code_domain_aggregate(jcfg, jx["deltas"], jx["n_k"], jx["pmask"], jx["ckeys"])
    _bitwise(tcomp.code_domain_aggregate(tcfg, tx["deltas"], tx["n_k"], tx["pmask"],
                                         tx["ckeys"]), want)
    jax_order = tcomp.jax_leaf_order(tx["deltas"])
    monkeypatch.setattr(tcomp, "jax_leaf_order", list)
    got = tcomp.code_domain_aggregate(tcfg, tx["deltas"], tx["n_k"], tx["pmask"], tx["ckeys"])
    want = params_from_jax(jax.tree.map(np.asarray, want))
    differ = {n for n in want if not torch.equal(got[n], want[n])}
    moved = {n for i, n in enumerate(tx["deltas"]) if jax_order.index(n) != i}
    assert differ <= moved and len(differ) >= 0.75 * len(moved) > 0, (differ, moved)


def test_sum_packed_codes_is_exact_int32():
    _, tcfg = _pair(kind="int4", packed=True)
    codes = torch.tensor([[7, -7, 3, 0, -1], [7, -7, -3, 5, 1]], dtype=torch.int8)
    from repro_torch.kernels import wire_pack

    total = tcomp.sum_packed_codes(tcfg, wire_pack.nibble_pack(codes), 5,
                                   weights=torch.tensor([3, 1000]))
    assert total.dtype == torch.int32
    assert total.tolist() == [7021, -7021, -2991, 5000, 997]
    with pytest.raises(ValueError, match="code-domain"):
        tcomp.sum_packed_codes(tcomp.CompressionConfig(kind="topk"), codes, 5)


def test_config_validation_matches_jax():
    for kw in (dict(kind="int2"), dict(kind="topk", topk_frac=0.0), dict(packed=True),
               dict(error_feedback=True)):
        with pytest.raises(ValueError):
            jcomp.CompressionConfig(**kw)
        with pytest.raises(ValueError):
            tcomp.CompressionConfig(**kw)
    tcomp.CompressionConfig(kind="int8", topk_frac=0.0)  # an inert knob passes


@pytest.mark.parametrize("bits,stochastic", [(8, True), (4, True), (4, False)])
def test_codes_layer_is_jax_bitwise(bits, stochastic):
    """One client's tensor on its own absmax scale, and back."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((5, 7)) * 0.01).astype(np.float32)
    kd = np.array([0x0BADF00D, 0xDEADBEEF], np.uint32)
    jcodes, jscale = jcomp.quantize_codes(jnp.asarray(x), jnp.asarray(kd), bits, stochastic)
    codes, scale = tcomp.quantize_codes(torch.from_numpy(x), torch.from_numpy(kd.astype(np.int64)),
                                        bits, stochastic)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert scale.item() == float(jscale) == float(tcomp.leaf_scale(torch.from_numpy(x), bits))
    np.testing.assert_array_equal(tcomp.dequantize_codes(codes, scale).numpy(),
                                  np.asarray(jcomp.dequantize_codes(jcodes, jscale)))
    assert float(tcomp.leaf_scale(torch.zeros(3), bits)) == 1.0


# ----------------------------------------------------------------- slow path


@pytest.fixture
def non_partitionable():
    """jax.random with the non-partitionable threefry (the pinned jax's
    default), restored after the test: the compressor splits its client
    keys over the leaves."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)


COMPRESSORS = [dict(kind=kind, packed=packed, stochastic=stochastic, topk_frac=0.25)
               for kind in ("int8", "int4", "topk") for packed in (False, True)
               for stochastic in (True, False) if kind != "topk" or stochastic]


@pytest.mark.parametrize("kw", COMPRESSORS,
                         ids=lambda kw: f"{kw['kind']}-{'packed' if kw['packed'] else 'graph'}"
                                        f"-{'stochastic' if kw['stochastic'] else 'nearest'}")
def test_make_compressor_is_jax_bitwise(non_partitionable, kw):
    """Every client's dequantized delta, each against its own scale and
    rounding keys split over the leaves in JAX's tree order, equals JAX's
    eager vmapped compressor bit for bit; packed and unpacked give the
    same bits, as the reference promises."""
    jcfg, tcfg = _pair(**kw)
    jx, tx = _round_inputs(5)
    want = jax.vmap(jcomp.make_compressor(jcfg))(jx["deltas"], jx["ckeys"])
    got = tcomp.make_compressor(tcfg)(tx["deltas"], tx["ckeys"])
    assert list(got) == list(tx["deltas"])
    _bitwise(got, want)
    other = tcomp.make_compressor(dataclasses.replace(tcfg, packed=not tcfg.packed))
    for name, v in other(tx["deltas"], tx["ckeys"]).items():
        assert torch.equal(v, got[name]), name


def test_the_uncompressed_compressor_is_the_identity():
    _, tx = _round_inputs(6)
    assert tcomp.make_compressor(tcomp.CompressionConfig())(tx["deltas"], None) is tx["deltas"]


@pytest.mark.parametrize("kind,frac", [("int8", 0.05), ("int4", 0.05), ("topk", 0.05),
                                       ("topk", 1e-6), ("topk", 1.0)])
@pytest.mark.parametrize("n", [1, 2, 7, 65, 4097])
def test_packed_leaf_bytes_are_the_wire_formula(kind, frac, n):
    """The materialized payload of one client holds exactly the bytes the
    formula prices: odd n, n = 1 and a top-k fraction below one element."""
    cfg = tcomp.CompressionConfig(kind=kind, topk_frac=frac, packed=True)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((K, n)).astype(np.float32))
    ckeys = keys.fold_in(keys.PRNGKey(1), torch.arange(K))
    payload = tcomp.pack_leaf(cfg, x, ckeys)
    assert all(a.shape[0] == K for a in payload)
    assert tcomp.packed_leaf_bytes(payload) == tcomp.leaf_wire_bytes(cfg, n)
    assert tcomp.leaf_wire_bytes(cfg, n) == jcomp.leaf_wire_bytes(
        jcomp.CompressionConfig(kind=kind, topk_frac=frac, packed=True), n)
    back = tcomp.unpack_leaf(cfg, payload, x.shape)
    assert back.shape == x.shape and back.dtype == torch.float32
