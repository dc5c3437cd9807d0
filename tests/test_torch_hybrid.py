"""The port's Zamba2 hybrid (``repro_torch/models/hybrid.py``) against the
JAX package's, JAX's parameters carried across by ``params_from_jax`` (the
stacked layout: groups on (G, E, ...), the tail on (tail, ...), one shared
block), in fp32, at zamba2-7b's smoke config (8 layers: two groups of 3 and
a tail of 2; its parameters drawn by the port's init and handed to both
as the same numpy arrays):

- the final hidden state, the loss and every leaf's gradient; the hidden
  state on the chunked SSD form (``ssm_chunked``) at a 4-layer cut (one
  group, a tail of 1);
- ``decode_step`` over a prompt and beyond from ``init_cache``: each
  step's logits against the reference's ``decode_step`` and against the
  port's teacher-forced forward, and the cache (every application's k/v,
  every layer's SSM and conv states) against the reference's;
- the configs field for field and zamba2-7b's 980,754,096 parameters at 7
  of its 81 layers on the meta device, in JAX's leaf order and shapes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import zamba2_7b as jzamba
from repro.models import hybrid as jh
from repro_torch.configs import zamba2_7b as tzamba
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.compression import jax_leaf_order
from repro_torch.core.task import get_task
from repro_torch.models import hybrid as th
from repro_torch.models import model_zoo

# outputs relative to their largest entry (at least 1): 8 Mamba2 layers and
# two applications of the shared attention block, fp32 sums in another order
TOL = 1e-5
# each gradient relative to its leaf's largest entry (at least 1)
GRAD_TOL = 2e-5
# decode against the teacher-forced forward: K11's one-token softmax against
# K10's blockwise one and the recurrence stepped against the full scan
DECODE_TOL = 1e-5
B, S, STEPS = 2, 12, 4
ZAMBA_PARAMS = 980_754_096


def _chunked_small():
    return dataclasses.replace(tzamba.make_smoke_config(), name="hybrid-ssd", n_layers=4,
                               ssm_chunked=True)


def _held(got, want, what: str, tol: float = TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, (what, err)


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat_np(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def smoke_params():
    """Parameters at the smoke config in JAX's tree, drawn by the port's
    init (the reference's initializers) and handed to both packages as the
    same numpy arrays: JAX's own nested ``stacked`` init takes 5.6 s jitted
    and 14 s eager here."""
    tparams = th.init_params(tzamba.make_smoke_config(), torch.Generator().manual_seed(0))
    return params_to_jax(tparams)


def _params_for(cfg, smoke: dict) -> dict:
    """The smoke parameters cut to ``cfg``'s groups and tail (the same
    widths and group length)."""
    out = {k: v for k, v in smoke.items() if k not in ("groups", "tail")}
    out["groups"] = jax.tree.map(lambda a: a[:cfg.n_groups], smoke["groups"])
    if cfg.tail:
        out["tail"] = jax.tree.map(lambda a: a[:cfg.tail], smoke["tail"])
    return out


@pytest.fixture(scope="module")
def case(smoke_params):
    """The reference's hidden state, loss and gradients at the smoke config."""
    cfg = tzamba.make_smoke_config()
    jcfg = jh.HybridConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    weight = np.array([1.0, 0.5], np.float32)
    hidden = jax.jit(lambda p, t: jh.forward(jcfg, p, t))(smoke_params, tokens)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jh.loss_fn(jcfg, p, b), has_aux=True))(
        smoke_params, {"tokens": jnp.asarray(tokens), "weight": jnp.asarray(weight)})
    return {"cfg": cfg, "jp": smoke_params, "tokens": tokens, "weight": weight,
            "hidden": np.asarray(hidden), "loss": float(loss),
            "grads": params_from_jax(jax.tree.map(np.asarray, grads))}


@pytest.fixture(scope="module")
def decoded(smoke_params):
    """The reference's decode at the smoke config (``ssm_chunked`` does not
    change decode): each step's logits and the final cache."""
    cfg = tzamba.make_smoke_config()
    jcfg = jh.HybridConfig(**dataclasses.asdict(cfg))
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    cache = jh.init_cache(jcfg, B, S + STEPS)
    decode = jax.jit(lambda p, c, t, pos: jh.decode_step(jcfg, p, c, t, pos))
    logits = []
    for t in range(S):
        lg, cache = decode(smoke_params, cache, tokens[:, t:t + 1], jnp.int32(t))
        logits.append(np.asarray(lg))
    return {"cfg": cfg, "jp": smoke_params, "tokens": tokens, "logits": logits,
            "cache": _flat_np(cache)}


def test_forward_loss_and_every_gradient_match_jax(case):
    cfg = case["cfg"]
    params = {k: v.requires_grad_(True) for k, v in params_from_jax(case["jp"]).items()}
    tokens = torch.from_numpy(case["tokens"]).long()
    with torch.no_grad():
        _held(th.forward(cfg, params, tokens), case["hidden"], "hidden")
    bundle = model_zoo.build_model(cfg, device="cpu")
    assert bundle.kind == "hybrid" and bundle.prefill is None
    loss, aux = bundle.loss_fn(params, {"tokens": tokens,
                                        "weight": torch.from_numpy(case["weight"])})
    np.testing.assert_allclose(float(loss.detach()), case["loss"], rtol=TOL)
    grads = torch.autograd.grad(aux["lm_loss"], list(params.values()))
    assert set(params) == set(case["grads"])
    for name, g in zip(params, grads):
        want = case["grads"][name].numpy()
        assert np.isfinite(want).all(), name
        _held(g, want, name, GRAD_TOL)


def test_the_chunked_ssd_flag_forward_matches_jax(smoke_params):
    """``ssm_chunked`` (the Mamba2 layers on the chunked SSD form) at a
    4-layer cut of the smoke config: one group and a tail of 1 (the
    reference's ``test_hybrid_chunked_flag`` holds the forward; the SSD
    form's gradients are held in tests/test_torch_ssm.py)."""
    cfg = _chunked_small()
    jcfg = jh.HybridConfig(**dataclasses.asdict(cfg))
    jp = _params_for(cfg, smoke_params)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    want = jax.jit(lambda p, t: jh.forward(jcfg, p, t))(jp, tokens)
    with torch.no_grad():
        got = th.forward(cfg, params_from_jax(jp), torch.from_numpy(tokens).long())
        plain = th.forward(dataclasses.replace(cfg, ssm_chunked=False), params_from_jax(jp),
                           torch.from_numpy(tokens).long())
    _held(got, want, "hidden on the SSD form")
    _held(got, plain.numpy(), "the SSD form against the scan", TOL)


def test_decode_matches_jax_and_the_teacher_forced_forward(decoded):
    case = decoded
    cfg = case["cfg"]
    params = params_from_jax(case["jp"])
    bundle = model_zoo.build_model(cfg, device="cpu")
    tokens = torch.from_numpy(case["tokens"]).long()
    with torch.no_grad():
        cache = bundle.init_cache(B, S + STEPS)
        assert cache["attn_k"].shape == (cfg.n_attn_applications, B, S + STEPS, cfg.n_kv,
                                         cfg.head_dim)
        steps = []
        for t in range(S):
            lg, cache = bundle.decode_step(params, cache, tokens[:, t:t + 1], t)
            _held(lg, case["logits"][t], f"decode step {t}")
            steps.append(lg)
        got = _flat_np(cache)
        assert got.keys() == case["cache"].keys()
        for name, want in case["cache"].items():
            _held(torch.from_numpy(got[name]), want, f"cache {name}")
        h = th.forward(cfg, params, tokens)
        tf = (h @ params["unembed"]).float()
    _held(torch.stack(steps, 1), tf.numpy(), "decode vs teacher-forced", DECODE_TOL)


def test_configs_and_the_full_width_task_are_the_references_field_for_field():
    for mine, want in ((tzamba.make_config(), jzamba.make_config()),
                       (tzamba.make_smoke_config(), jzamba.make_smoke_config()),
                       (tzamba.make_config(n_layers=7),
                        dataclasses.replace(jzamba.make_config(), n_layers=7))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(want)
    cfg = tzamba.make_config(n_layers=7)
    assert (cfg.n_groups, cfg.tail, cfg.n_attn_applications) == (1, 1, 2)
    full = tzamba.make_config()
    assert (full.n_groups, full.tail, full.n_attn_applications) == (13, 3, 14)
    assert dataclasses.asdict(cfg.mamba_cfg()) == dataclasses.asdict(
        jh.HybridConfig(**dataclasses.asdict(cfg)).mamba_cfg())
    task = get_task("zamba2-7b")
    assert task.config == cfg and (task.kind, task.quality_metric) == ("hybrid", "ppl")


def test_zamba2_7b_parameters_on_the_meta_device_are_the_references():
    """980,754,096 bf16 parameters in 40 leaves at 7 layers, in JAX's leaf
    order, each of the reference's shape (``jax.eval_shape``)."""
    cfg = get_task("zamba2-7b").config
    params = th.init_params(cfg, torch.Generator(), device="meta")
    assert sum(t.numel() for t in params.values()) == ZAMBA_PARAMS
    jcfg = dataclasses.replace(jzamba.make_config(), n_layers=7)
    shapes = jax.eval_shape(lambda k: jh.init_params(jcfg, k), jax.random.PRNGKey(0))
    paths, _ = jax.tree_util.tree_flatten_with_path(shapes)
    names = [".".join(str(p.key) for p in path) for path, _ in paths]
    assert len(params) == 40 and jax_leaf_order(params) == names
    for (_, leaf), name in zip(paths, names):
        assert tuple(params[name].shape) == leaf.shape, name
        assert params[name].dtype == torch.bfloat16 and leaf.dtype == jnp.bfloat16
    cache = th.init_cache(cfg, 4, 160, device="meta")
    nbytes = sum(t.numel() * t.element_size() for t in _flat_np_meta(cache))
    assert nbytes == 70_956_032


def _flat_np_meta(tree):
    for v in tree.values():
        yield from (_flat_np_meta(v) if isinstance(v, dict) else (v,))
