"""gemma3-4b's head width of 256 in the port against the JAX package, in fp32
on the CPU (JAX's parameters carried across by ``params_from_jax``): the
plain ``blockwise_attention`` at D = Dv = 256 with GQA, the window acting
and a ragged length, with every gradient; the plain decode attention at D =
256, G = 2, with the window acting; a head-width-256 smoke transformer
(gemma3's smoke config with 2 heads on 1 kv head of 256: layer 0 local
with a window of 16, layer 1 global) over 40 tokens: its forward, loss,
every gradient, prefill, decode over prefill's cache grown, and one FedAvg
round with FVN against the reference's jitted engine; one bf16 forward of
that config, which holds the embedding scale's rounding to bf16 (sqrt(128)
to 11.3125); and the 6-layer full-width config's parameters on the meta
device against ``jax.eval_shape``'s. Every JAX draw runs with the
non-partitionable threefry (the pinned jax's default), set and restored
around it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_4b as jg3
from repro.core import FederatedPlan as JaxPlan
from repro.core import FVNConfig as JaxFVN
from repro.core import build_round_engine as jax_engine
from repro.core.task import task_for_config as jax_task_for_config
from repro.data import FederatedSampler as JaxSampler
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch.configs import gemma3_4b as tg3
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import jax_leaf_order
from repro_torch.core.engine import build_round_engine
from repro_torch.core.plan import FederatedPlan, FVNConfig
from repro_torch.core.task import task_for_config
from repro_torch.models import attention as tattn
from repro_torch.models import model_zoo
from repro_torch.models import transformer as ttr

# fp32: relative to the largest entry of each output (at least 1), as
# tests/test_torch_mla.py: the same products summed in another order,
# through 2 layers and a vocab-wide product
TOL = 1e-5
GRAD_TOL = 1e-5
# bf16: both packages round the same fp32 sums to bf16 at other places
# (matmul blocking, the softmax's fp32 sums), a few bf16 ulps (2**-8 of an
# entry each) through 2 layers, relative to the largest entry (9.2e-03
# read here); chip_smoke.py's TINY_SERVE_TOL for bf16
BF16_TOL = 2e-2
B, S, STEPS = 2, 40, 4
GEMMA3_LAYERS, GEMMA3_PARAMS = 6, 1_908_444_672
K, LIMIT = 2, 2            # two clients, data limit 2 at b = 2: one local step
ROUND_LOSS_RTOL = 1e-5     # as tests/test_torch_lm_tasks.py
PARAM_TOL = 1e-5
PLAN = dict(clients_per_round=K, local_batch_size=B, data_limit=LIMIT, client_lr=0.05,
            server_optimizer="sgd", server_lr=1.0)


def _d256(cfg):
    """A gemma3 smoke config at gemma3-4b's head width: 2 heads on 1 kv head of 256."""
    return dataclasses.replace(cfg, head_dim=256, n_heads=2, n_kv=1)


def _non_partitionable(fn):
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        return fn()
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _held(got: torch.Tensor, want, what: str, tol: float = TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, (what, err)


# ------------------------------------------------------------------ attention

@pytest.mark.parametrize("window", [16, None], ids=["window", "global"])
def test_blockwise_attention_at_width_256_matches_jax(window):
    """D = Dv = 256, 4 heads on 2 kv heads, causal over a ragged 37 tokens
    (8-key blocks in both, the last one short), a window of 16 that drops
    keys from row 16 on: the output and the gradients of q, k and v
    against jax.grad of the reference's blockwise_attention."""
    rng = np.random.default_rng(256 + (window or 0))
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32) for sh in
                   ((1, 37, 4, 256), (1, 37, 2, 256), (1, 37, 2, 256), (1, 37, 4, 256)))

    def f(q, k, v):
        o = jattn.blockwise_attention(q, k, v, causal=True, window=window, block_kv=8)
        return jnp.sum(o * do), o

    (_, want), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn.blockwise_attention(qt, kt, vt, causal=True, window=window, block_kv=8)
    _held(o, want, "o")
    got = torch.autograd.grad((o * torch.from_numpy(do)).sum(), (qt, kt, vt))
    for g, w, what in zip(got, grads, ("dq", "dk", "dv")):
        _held(g, w, what, GRAD_TOL)


@pytest.mark.parametrize("pos", [30, 47], ids=["inside", "last slot"])
def test_decode_attention_at_width_256_matches_jax(pos):
    """One token of 4 heads on 2 kv heads of 256 (G = 2) against a 48-slot
    cache at pos, the window of 16 acting (slots pos - 15 .. pos)."""
    rng = np.random.default_rng(pos)
    q, kc, vc = (rng.standard_normal(sh).astype(np.float32) for sh in
                 ((2, 4, 256), (2, 48, 2, 256), (2, 48, 2, 256)))
    want = jattn.decode_attention(q, kc, vc, jnp.int32(pos), window=16)
    got = tattn.decode_attention(*map(torch.from_numpy, (q, kc, vc)), pos, window=16)
    _held(got, want, "decode")
    wide = jattn.decode_attention(q, kc, vc, jnp.int32(pos), window=None)
    assert np.abs(np.asarray(wide) - np.asarray(want)).max() > 1e-3  # the window acts


# ------------------------------------------------------------------ the smoke transformer

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


@pytest.fixture(scope="module")
def smoke_case():
    """The head-width-256 smoke transformer's JAX results over 40 tokens:
    the final hidden, the loss (a row weighted 0.5) and its gradients,
    prefill, and STEPS decode steps over prefill's cache grown."""
    cfg, jcfg = _d256(tg3.make_smoke_config()), _d256(jg3.make_smoke_config())
    jp = jax.tree.map(np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(34)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    weight = np.array([1.0, 0.5], np.float32)
    steps = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    hidden = jax.jit(lambda p, t: jtr.forward(jcfg, p, t)[0])(jp, tokens)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(jcfg, p, b), has_aux=True))(
        jp, {"tokens": tokens, "weight": weight})
    logits, cache = jax.jit(lambda p, t: jtr.prefill(jcfg, p, t))(jp, tokens)
    grown = _grow(cache, S + STEPS)
    jdecode = jax.jit(lambda p, c, t, pos: jtr.decode_step(jcfg, p, c, t, pos))
    dcache, dlogits = jax.tree.map(jnp.asarray, grown), []
    for i in range(STEPS):
        lg, dcache = jdecode(jp, dcache, steps[i], jnp.int32(S + i))
        dlogits.append(np.asarray(lg))
    return {"cfg": cfg, "jcfg": jcfg, "jp": jp, "tokens": tokens, "weight": weight,
            "steps": steps, "hidden": np.asarray(hidden), "loss": float(loss),
            "lm_loss": float(parts["lm_loss"]),
            "grads": params_from_jax(jax.tree.map(np.asarray, grads)),
            "logits": np.asarray(logits), "cache": jax.tree.map(np.asarray, cache),
            "grown": grown, "dlogits": dlogits, "dcache": jax.tree.map(np.asarray, dcache)}


def test_the_smoke_config_at_width_256_has_a_local_and_a_global_layer(smoke_case):
    cfg = smoke_case["cfg"]
    assert (cfg.n_layers, cfg.head_dim, cfg.n_heads, cfg.n_kv) == (2, 256, 2, 1)
    assert cfg.layer_windows() == [16, 0] == np.asarray(smoke_case["jcfg"].layer_windows()).tolist()
    assert S > cfg.window  # the window masks keys in layer 0


def test_smoke_forward_loss_and_every_gradient_match_jax(smoke_case):
    params = {k: v.requires_grad_() for k, v in params_from_jax(smoke_case["jp"]).items()}
    mine = ttr.init_params(smoke_case["cfg"], torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    cfg, tt = smoke_case["cfg"], torch.from_numpy(smoke_case["tokens"])
    _held(ttr.forward(cfg, params, tt)[0], smoke_case["hidden"], "forward")
    loss, parts = ttr.loss_fn(cfg, params, {"tokens": tt,
                                            "weight": torch.from_numpy(smoke_case["weight"])})
    np.testing.assert_allclose(float(loss.detach()), smoke_case["loss"], rtol=TOL)
    np.testing.assert_allclose(float(parts["lm_loss"].detach()), smoke_case["lm_loss"], rtol=TOL)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert set(params) == set(smoke_case["grads"])
    for name, g in zip(params, grads):
        _held(g, smoke_case["grads"][name].numpy(), name, GRAD_TOL)


def test_smoke_prefill_and_decode_over_the_grown_cache_match_jax(smoke_case):
    """Prefill's logits and cache, then STEPS decode steps over the cache
    grown to 44 slots (F6): the local layer's K11 masks by the window, the
    cache is whole for every layer (global_every != 0: no ring)."""
    params = params_from_jax(smoke_case["jp"])
    bundle = model_zoo.build_model(smoke_case["cfg"], device="cpu")
    with torch.no_grad():
        logits, cache = bundle.prefill(params, {"tokens": torch.from_numpy(smoke_case["tokens"])})
        _held(logits, smoke_case["logits"], "prefill logits")
        for prefix, kv in smoke_case["cache"].items():
            for name, want in kv.items():
                _held(cache[prefix][name], want, f"prefill cache {prefix}.{name}")
        full = bundle.init_cache(B, S + STEPS)
        assert {p: {n: tuple(t.shape) for n, t in kv.items()} for p, kv in full.items()} == \
            {p: {n: a.shape for n, a in kv.items()} for p, kv in smoke_case["grown"].items()}
        for prefix, kv in cache.items():
            for name, t in kv.items():
                full[prefix][name][:, :, :S].copy_(t)
        for i in range(STEPS):
            logits, full = bundle.decode_step(params, full,
                                              torch.from_numpy(smoke_case["steps"][i]), S + i)
            _held(logits, smoke_case["dlogits"][i], f"decode step {i}")
    for prefix, kv in smoke_case["dcache"].items():
        for name, want in kv.items():
            _held(full[prefix][name], want, f"decode cache {prefix}.{name}")


def test_a_bf16_forward_holds_the_embedding_scales_rounding(smoke_case):
    """bf16 compute and parameters: sqrt(d_model) = sqrt(128) rounds to
    11.3125 before the multiply, in both packages (embed_tokens bitwise the
    reference's), and the forward's final hidden and prefill's logits
    within BF16_TOL of the reference's."""
    cfg = dataclasses.replace(smoke_case["cfg"], dtype="bfloat16", param_dtype="bfloat16")
    jcfg = dataclasses.replace(smoke_case["jcfg"], dtype="bfloat16", param_dtype="bfloat16")
    # both round the same fp32 parameters to bf16, to nearest even
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), smoke_case["jp"])
    params = {k: v.to(torch.bfloat16) for k, v in params_from_jax(smoke_case["jp"]).items()}
    assert {t.dtype for t in params.values()} == {torch.bfloat16}
    tokens = smoke_case["tokens"]
    tt = torch.from_numpy(tokens)
    emb = ttr.embed_tokens(cfg, params, tt)
    want_emb = np.asarray(jtr.embed_tokens(jcfg, jp, tokens).astype(jnp.float32))
    assert np.array_equal(emb.float().numpy(), want_emb)
    assert float(torch.tensor(cfg.d_model ** 0.5, dtype=torch.bfloat16)) == 11.3125
    assert torch.equal(emb, params["embed"][tt] * torch.tensor(11.3125, dtype=torch.bfloat16))
    with torch.no_grad():
        _held(ttr.forward(cfg, params, tt)[0],
              jax.jit(lambda p, t: jtr.forward(jcfg, p, t)[0])(jp, tokens).astype(jnp.float32),
              "bf16 forward", BF16_TOL)
        logits, _ = ttr.prefill(cfg, params, tt)
    want, _ = jax.jit(lambda p, t: jtr.prefill(jcfg, p, t))(jp, tokens)
    _held(logits, np.asarray(want.astype(jnp.float32)), "bf16 prefill logits", BF16_TOL)


def test_one_fedavg_round_at_width_256_matches_the_reference_engine():
    """One round (K = 2, one local step, FVN on) of task_for_config(the
    head-width-256 smoke config) against the reference's jitted engine over
    the same parameters and batch; then the perplexity evaluation."""
    jtask = jax_task_for_config(_d256(jg3.make_smoke_config()))
    jparams = jax.tree.map(np.asarray, jtask.bundle.init(jax.random.PRNGKey(0)))
    corpus = jtask.make_corpus(0)
    batch = JaxSampler(corpus, clients_per_round=K, local_batch_size=B, data_limit=LIMIT,
                       seed=0).next_round().engine_batch()

    def run():
        plan = JaxPlan(**PLAN, fvn=JaxFVN(enabled=True, std=0.01))
        engine = jax_engine(plan, jtask, base_key=jax.random.PRNGKey(1))
        state, metrics = jax.jit(engine.step)(engine.init_state(jparams),
                                              jax.tree.map(jnp.asarray, batch))
        return {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, state.params)

    jm, after = _non_partitionable(run)
    task = task_for_config(_d256(tg3.make_smoke_config()))
    assert (task.kind, task.quality_metric) == (jtask.kind, jtask.quality_metric)
    engine = build_round_engine(FederatedPlan(**PLAN, fvn=FVNConfig(enabled=True, std=0.01)),
                                task, seed=1)
    state, metrics = engine.step(engine.init_state(params_from_jax(jparams)),
                                 {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    np.testing.assert_allclose(metrics["loss"], jm["loss"], rtol=ROUND_LOSS_RTOL)
    np.testing.assert_allclose(metrics["delta_norm"], jm["delta_norm"], rtol=ROUND_LOSS_RTOL)
    want = params_from_jax(after)
    assert set(state.params) == set(want)
    for name, p in state.params.items():
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=PARAM_TOL * scale,
                                   rtol=0, err_msg=name)
    got = task.evaluate(state.params, task.make_corpus(0), 8)
    for k, v in jtask.evaluate(after, corpus, 8).items():
        np.testing.assert_allclose(got[k], v, rtol=ROUND_LOSS_RTOL)


# ------------------------------------------------------------------ the card run's size

def test_six_layers_at_full_width_have_the_references_parameters():
    """chip_smoke.py's gemma3-4b: 6 of 34 layers (5 local, 1 global) at
    full width, 1,908,444,672 bf16 parameters, each leaf of the reference's
    shape and dtype in its order (the port's on the meta device,
    ``jax.eval_shape``'s: neither allocates)."""
    cfg = tg3.make_config(n_layers=GEMMA3_LAYERS)
    assert cfg == dataclasses.replace(tg3.make_config(), n_layers=GEMMA3_LAYERS)
    assert cfg.layer_windows() == [1024] * 5 + [0]
    params = ttr.init_params(cfg, torch.Generator(), device="meta")
    assert sum(t.numel() for t in params.values()) == GEMMA3_PARAMS
    shapes = jax.eval_shape(lambda k: jtr.init_params(dataclasses.replace(
        jg3.make_config(), n_layers=GEMMA3_LAYERS), k), jax.random.PRNGKey(0))
    paths, _ = jax.tree_util.tree_flatten_with_path(shapes)
    jax_names = [".".join(str(p.key) for p in path) for path, _ in paths]
    assert jax_leaf_order(params) == jax_names
    for (_, leaf), name in zip(paths, jax_names):
        assert tuple(params[name].shape) == leaf.shape, name
        assert str(params[name].dtype).split(".")[-1] == str(leaf.dtype), name
    assert params["embed"].shape == (262144, 2560)
    assert params["layers.attn.wq"].shape == (GEMMA3_LAYERS, 2560, 8 * 256)
