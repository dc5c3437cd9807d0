"""The port's decoder-only transformer (``repro_torch/models/transformer.py``)
against the JAX package's, JAX's parameters carried across by
``params_from_jax`` (the stacked layout: the leaves pass unchanged), in
fp32 at four configs: the reference's ``lm-tiny``, qwen3's smoke config
(GQA 4 on 2, qk_norm), a windowed config whose layers mix local and
global attention (window 8, every second layer global) and a MoE config
with a leading dense layer (``moe_first_dense=1``). For each: the final
hidden state and aux loss, ``loss_fn`` (lm and aux), every leaf's
gradient, ``prefill``'s logits and cache, and 4 ``decode_step``s over
prefill's cache grown by 4 slots. A ring-buffer cache (``ring=True``,
sized at the window) is decoded past its width in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs import qwen3_8b as tqwen
from repro_torch.convert import params_from_jax
from repro_torch.core.task import tiny_lm_config
from repro_torch.models import model_zoo
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr

# Relative to the largest entry of each output (hidden states ~4, logits ~3,
# caches ~3): fp32 sums of the same products in another order, through 2-4
# layers and a vocab-wide product (a few 1e-7 seen).
TOL = 1e-5
# each gradient relative to its leaf's largest entry (at least 1)
GRAD_TOL = 1e-5
B, S, STEPS = 2, 16, 4


def _windowed():
    return dataclasses.replace(tiny_lm_config(), name="lm-windowed", n_layers=4, window=8,
                               global_every=2)


def _moe_dense_first():
    return dataclasses.replace(
        tiny_lm_config(), name="moe-dense-first", n_layers=3, moe_first_dense=1,
        first_dense_ff=48, moe=tmoe.MoEConfig(n_experts=4, top_k=2, expert_ff=32,
                                              capacity_factor=1.0, n_shared=1))


CONFIGS = {
    "lm-tiny": tiny_lm_config,
    "qwen3-smoke": tqwen.make_smoke_config,
    "windowed": _windowed,
    "moe-dense-first": _moe_dense_first,
}


def jax_config(cfg: ttr.TransformerConfig) -> jtr.TransformerConfig:
    """The reference's config with the port's fields."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        fields["moe"] = jmoe.MoEConfig(**dataclasses.asdict(cfg.moe))
    return jtr.TransformerConfig(**fields)


def _held(got: torch.Tensor, want, what: str, tol: float = TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, (what, err)


def _grow(cache, total: int):
    """Prefill's cache copied into zeros of ``total`` slots (numpy)."""
    out = {}
    for prefix, kv in cache.items():
        out[prefix] = {}
        for name, a in kv.items():
            a = np.asarray(a)
            z = np.zeros(a.shape[:2] + (total,) + a.shape[3:], a.dtype)
            z[:, :, :a.shape[2]] = a
            out[prefix][name] = z
    return out


def _torch_cache(cache) -> dict:
    return {p: {n: torch.from_numpy(np.array(a)) for n, a in kv.items()}
            for p, kv in cache.items()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """One config's JAX results: the forward, the loss and its gradients,
    prefill, and STEPS decode steps over prefill's cache grown by STEPS."""
    cfg = CONFIGS[request.param]()
    jcfg = jax_config(cfg)
    jp = jax.tree.map(np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    weight = np.array([1.0, 0.5], np.float32)
    steps = rng.integers(0, cfg.vocab, size=(STEPS, B, 1)).astype(np.int32)

    hidden, aux = jax.jit(lambda p, t: jtr.forward(jcfg, p, t))(jp, tokens)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(jcfg, p, b), has_aux=True))(
        jp, {"tokens": jnp.asarray(tokens), "weight": jnp.asarray(weight)})
    logits, cache = jax.jit(lambda p, t: jtr.prefill(jcfg, p, t))(jp, tokens)
    grown = _grow(cache, S + STEPS)
    jdecode = jax.jit(lambda p, c, t, pos: jtr.decode_step(jcfg, p, c, t, pos))
    dcache, dlogits = jax.tree.map(jnp.asarray, grown), []
    for i in range(STEPS):
        lg, dcache = jdecode(jp, dcache, steps[i], jnp.int32(S + i))
        dlogits.append(np.asarray(lg))
    return {
        "name": request.param, "cfg": cfg, "jp": jp, "tokens": tokens, "weight": weight,
        "steps": steps, "hidden": np.asarray(hidden), "aux": float(aux),
        "loss": float(loss), "parts": {k: float(v) for k, v in parts.items()},
        "grads": params_from_jax(jax.tree.map(np.asarray, grads)),
        "logits": np.asarray(logits), "cache": jax.tree.map(np.asarray, cache),
        "grown": grown, "dlogits": dlogits,
        "dcache": jax.tree.map(np.asarray, dcache),
    }


def test_configs_and_windows_are_the_references(case):
    cfg = case["cfg"]
    jcfg = jax_config(cfg)
    assert cfg.layer_windows() == [int(w) for w in jcfg.layer_windows()]
    if case["name"] == "windowed":
        assert cfg.layer_windows() == [8, 0, 8, 0]
    params = params_from_jax(case["jp"])
    mine = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in params.items()}


def test_forward_hidden_and_aux_match_jax(case):
    params = params_from_jax(case["jp"])
    hidden, aux = ttr.forward(case["cfg"], params, torch.from_numpy(case["tokens"]))
    _held(hidden, case["hidden"], "hidden")
    np.testing.assert_allclose(float(aux), case["aux"], rtol=TOL, atol=1e-7)


def test_loss_and_every_gradient_match_jax(case):
    params = {k: v.requires_grad_() for k, v in params_from_jax(case["jp"]).items()}
    batch = {"tokens": torch.from_numpy(case["tokens"]),
             "weight": torch.from_numpy(case["weight"])}
    loss, parts = ttr.loss_fn(case["cfg"], params, batch)
    np.testing.assert_allclose(float(loss.detach()), case["loss"], rtol=TOL)
    np.testing.assert_allclose(float(parts["lm_loss"].detach()), case["parts"]["lm_loss"],
                               rtol=TOL)
    np.testing.assert_allclose(float(parts["aux_loss"].detach()), case["parts"]["aux_loss"],
                               rtol=TOL, atol=1e-7)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert set(params) == set(case["grads"])
    for name, g in zip(params, grads):
        _held(g, case["grads"][name].numpy(), name, GRAD_TOL)


def test_prefill_logits_and_cache_match_jax(case):
    params = params_from_jax(case["jp"])
    bundle = model_zoo.build_model(case["cfg"], device="cpu")
    logits, cache = bundle.prefill(params, {"tokens": torch.from_numpy(case["tokens"])})
    _held(logits, case["logits"], "prefill logits")
    assert cache.keys() == case["cache"].keys()
    for prefix, kv in case["cache"].items():
        for name, want in kv.items():
            _held(cache[prefix][name], want, f"prefill cache {prefix}.{name}")


def test_decode_steps_over_the_grown_cache_match_jax(case):
    params = params_from_jax(case["jp"])
    bundle = model_zoo.build_model(case["cfg"], device="cpu")
    cache = _torch_cache(case["grown"])
    for i in range(STEPS):
        logits, cache = bundle.decode_step(params, cache, torch.from_numpy(case["steps"][i]),
                                           S + i)
        _held(logits, case["dlogits"][i], f"decode step {i}")
    for prefix, kv in case["dcache"].items():
        for name, want in kv.items():
            _held(cache[prefix][name], want, f"decode cache {prefix}.{name}")


RING_STEPS = 12  # past the ring's 8 slots: the oldest entries are overwritten


@pytest.mark.parametrize("global_every", [0, 2])
def test_ring_decode_matches_jax(global_every):
    """Decoding from an empty ``init_cache(ring=True)``: every layer windowed
    (global_every 0: the cache is sized at the window, 8 slots, and the
    ring wraps) and every second layer global (the cache is seq_len wide)."""
    cfg = dataclasses.replace(_windowed(), global_every=global_every)
    jcfg = jax_config(cfg)
    jp = jax.tree.map(np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(1)))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (RING_STEPS, B, 1)).astype(np.int32)
    jcache = jtr.init_cache(jcfg, B, 32, ring=True)
    cache = ttr.init_cache(cfg, B, 32, ring=True, device="cpu")
    want_slots = 8 if global_every == 0 else 32
    assert cache["layers"]["k"].shape == (4, B, want_slots, 2, 16) == jcache["layers"]["k"].shape
    jdecode = jax.jit(lambda p, c, t, pos: jtr.decode_step(jcfg, p, c, t, pos, ring=True))
    params = params_from_jax(jp)
    for i in range(RING_STEPS):
        want, jcache = jdecode(jp, jcache, tokens[i], jnp.int32(i))
        got, cache = ttr.decode_step(cfg, params, cache, torch.from_numpy(tokens[i]), i,
                                     ring=True)
        _held(got, np.asarray(want), f"ring step {i}")
    _held(cache["layers"]["k"], np.asarray(jcache["layers"]["k"]), "ring cache")


def test_prefill_cache_clamp_is_the_references():
    """A decode step straight after prefill (the cache as long as the
    prompt) writes at pos clamped into the cache: its last slot, in both
    packages (F6)."""
    cfg = tiny_lm_config()
    jcfg = jax_config(cfg)
    jp = jax.tree.map(np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(2)))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, 6)).astype(np.int32)
    nxt = np.full((B, 1), 3, np.int32)
    _, jcache = jtr.prefill(jcfg, jp, tokens)
    want, jcache = jtr.decode_step(jcfg, jp, jcache, nxt, jnp.int32(6))
    params = params_from_jax(jp)
    _, cache = ttr.prefill(cfg, params, torch.from_numpy(tokens))
    got, cache = ttr.decode_step(cfg, params, cache, torch.from_numpy(nxt), 6)
    _held(got, np.asarray(want), "clamped step")
    _held(cache["layers"]["v"], np.asarray(jcache["layers"]["v"]), "clamped cache")
