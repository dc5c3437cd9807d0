"""The port's multi-head latent attention (``repro_torch/models/mla.py``) and
the deepseek-v2-lite-16b transformer against the JAX package's, JAX's
parameters carried across by ``params_from_jax``, in fp32 on the CPU:
``mla_forward`` and every gradient of it, ``mla_decode`` at positions
inside and past its cache, the port's ``blockwise_attention`` at MLA's
q·k width 192 and v width 128 with its query scale, the deepseek smoke
transformer's loss and gradients, ``prefill`` and ``decode_step`` (with
F6's clamp on the compressed caches and F7: MLA ignores the window and the
ring), one FedAvg round of its task against the reference's jitted engine,
and the registered full-width task's configuration and parameter count.
A round with bf16 leaves beside the fp32 router keeps each leaf's dtype.
Every JAX draw runs with the non-partitionable threefry (the pinned jax's
default), set and restored around it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_lite_16b as jds
from repro.core import FederatedPlan as JaxPlan
from repro.core import FVNConfig as JaxFVN
from repro.core import build_round_engine as jax_engine
from repro.core.task import task_for_config as jax_task_for_config
from repro.data import FederatedSampler as JaxSampler
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro.models import transformer as jtr
from repro_torch.configs import deepseek_v2_lite_16b as tds
from repro_torch.convert import params_from_jax
from repro_torch.core import task as ttask
from repro_torch.core.compression import jax_leaf_order
from repro_torch.core.engine import build_round_engine
from repro_torch.core.plan import FederatedPlan, FVNConfig
from repro_torch.core.task import get_task, task_for_config
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla
from repro_torch.models import model_zoo
from repro_torch.models import transformer as ttr

# Relative to the largest entry of each output (at least 1), as
# tests/test_torch_transformer.py: fp32 sums of the same products in another
# order, through up to 3 layers and a vocab-wide product
TOL = 1e-5
GRAD_TOL = 1e-5
B, S, STEPS = 2, 12, 4
# the smoke MLAConfig (repro/configs/deepseek_v2_lite_16b.py:41-42)
MLA_SMOKE = dict(d_model=128, n_heads=4, kv_lora=64, qk_nope_dim=32, qk_rope_dim=16, v_dim=32)
DEEPSEEK_PARAMS = 1_085_287_424
K, LIMIT = 2, 2            # two clients, data limit 2 at b = 2: one local step
ROUND_LOSS_RTOL = 1e-5     # as tests/test_torch_lm_tasks.py
PARAM_TOL = 1e-5
PLAN = dict(clients_per_round=K, local_batch_size=B, data_limit=LIMIT, client_lr=0.05,
            server_optimizer="sgd", server_lr=1.0)


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


# ------------------------------------------------------------------ configs

def test_configs_are_the_references_field_for_field():
    for mine, ref in ((tds.make_config(n_layers=2),
                       dataclasses.replace(jds.make_config(), n_layers=2)),
                      (tds.make_config(), jds.make_config()),
                      (tds.make_smoke_config(), jds.make_smoke_config()),
                      (tds.make_config(window=4096), jds.ARCH.make_long_config())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    task = get_task("deepseek-v2-lite-16b")
    assert task.config == tds.make_config(n_layers=2)
    assert (task.name, task.kind, task.quality_metric) == ("deepseek-v2-lite-16b", "moe", "ppl")
    assert task.make_corpus is ttask.deepseek_width_corpus
    assert ttask.DEEPSEEK_CORPUS == {**ttask.QWEN_CORPUS, "vocab_size": 102400}


def test_deepseek_parameters_on_the_meta_device_are_the_references():
    """1,085,287,424 parameters in 31 leaves at 2 layers, in JAX's leaf
    order, each of the reference's shape and dtype (bf16, the MoE router
    fp32; ``jax.eval_shape``: no memory on either side)."""
    cfg = get_task("deepseek-v2-lite-16b").config
    params = ttr.init_params(cfg, torch.Generator(), device="meta")
    assert sum(t.numel() for t in params.values()) == DEEPSEEK_PARAMS
    shapes = jax.eval_shape(lambda k: jtr.init_params(dataclasses.replace(
        jds.make_config(), n_layers=2), k), jax.random.PRNGKey(0))
    paths, _ = jax.tree_util.tree_flatten_with_path(shapes)
    jax_names = [".".join(str(p.key) for p in path) for path, _ in paths]
    assert len(params) == 31 and jax_leaf_order(params) == jax_names
    for (_, leaf), name in zip(paths, jax_names):
        assert tuple(params[name].shape) == leaf.shape, name
        assert str(params[name].dtype).split(".")[-1] == str(leaf.dtype), name
    assert params["layers.moe.router"].dtype == torch.float32
    assert params["layers.attn.w_uk"].shape == (1, 512, 16 * 128)


# ------------------------------------------------------------------ mla.py

@pytest.fixture(scope="module")
def mla_case():
    """The reference's MLA parameters, an input, mla_forward's output,
    caches and the gradients of <out, cot> with respect to every leaf and x."""
    jcfg = jmla.MLAConfig(**MLA_SMOKE)
    jp = jax.tree.map(np.asarray, jmla.mla_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, MLA_SMOKE["d_model"])).astype(np.float32)
    cot = rng.standard_normal((B, S, MLA_SMOKE["d_model"])).astype(np.float32)

    def f(p, x):
        out, (c_kv, k_rope) = jmla.mla_forward(p, jcfg, x)
        return jnp.sum(out * cot), (out, c_kv, k_rope)

    (_, outs), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(jp, x)
    return {"jcfg": jcfg, "jp": jp, "x": x, "cot": cot,
            "outs": [np.asarray(o) for o in outs],
            "gp": params_from_jax(jax.tree.map(np.asarray, gp)), "gx": np.asarray(gx)}


def test_mla_init_has_the_references_leaves(mla_case):
    mine = tmla.mla_init(torch.Generator().manual_seed(0), tmla.MLAConfig(**MLA_SMOKE))
    want = params_from_jax(mla_case["jp"])
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in want.items()}


def test_mla_forward_and_every_gradient_match_jax(mla_case):
    cfg = tmla.MLAConfig(**MLA_SMOKE)
    params = {k: v.requires_grad_() for k, v in params_from_jax(mla_case["jp"]).items()}
    x = torch.from_numpy(mla_case["x"]).requires_grad_()
    out, (c_kv, k_rope) = tmla.mla_forward(params, cfg, x)
    for got, want, what in zip((out, c_kv, k_rope), mla_case["outs"], ("out", "c_kv", "k_rope")):
        _held(got, want, what)
    loss = (out * torch.from_numpy(mla_case["cot"])).sum()
    grads = torch.autograd.grad(loss, [x, *params.values()])
    _held(grads[0], mla_case["gx"], "dx", GRAD_TOL)
    for name, g in zip(params, grads[1:]):
        _held(g, mla_case["gp"][name].numpy(), f"d{name}", GRAD_TOL)


CACHE_S = 10


@pytest.mark.parametrize("pos", [0, 4, CACHE_S - 1, CACHE_S + 3])
def test_mla_decode_matches_jax_and_writes_the_caches(mla_case, pos):
    """One token against random compressed caches of 10 slots; a position
    past the cache writes its last slot (clamped, F6) and every slot is
    valid, in both packages."""
    cfg = tmla.MLAConfig(**MLA_SMOKE)
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, CACHE_S, cfg.kv_lora)).astype(np.float32)
    krope = rng.standard_normal((B, CACHE_S, cfg.qk_rope_dim)).astype(np.float32)
    want = jax.jit(lambda p, x, c, r, t: jmla.mla_decode(p, mla_case["jcfg"], x, c, r, t))(
        mla_case["jp"], x, ckv, krope, jnp.int32(pos))
    params = params_from_jax(mla_case["jp"])
    ckv_t, krope_t = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    out, ckv_o, krope_o = tmla.mla_decode(params, cfg, torch.from_numpy(x), ckv_t, krope_t, pos)
    assert ckv_o is ckv_t and krope_o is krope_t  # written in place
    for got, w, what in zip((out, ckv_o, krope_o), want, ("out", "ckv", "krope")):
        _held(got, w, f"{what} at pos {pos}")
    slot = min(pos, CACHE_S - 1)
    assert not np.array_equal(ckv_o[:, slot].numpy(), ckv[:, slot])
    keep = [i for i in range(CACHE_S) if i != slot]
    assert np.array_equal(ckv_o[:, keep].numpy(), ckv[:, keep])


@pytest.mark.parametrize("causal,kv", [(True, 2), (False, 1)], ids=["causal", "gqa-full"])
def test_blockwise_attention_at_mla_widths_matches_jax(causal, kv):
    """D = 192 (128 + 64), Dv = 128 with MLA's query scale, B = 1, S = 20,
    H = 2: the output and the gradients of q, k and v against jax.grad of
    the reference's blockwise_attention (8-key blocks in both), and the
    kernels' width contract on the card side (D, Dv <= 256)."""
    rng = np.random.default_rng(192 + kv)
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32) for sh in
                   ((1, 20, 2, 192), (1, 20, kv, 192), (1, 20, kv, 128), (1, 20, 2, 128)))
    scale = 192 ** -0.5

    def f(q, k, v):
        o = jattn.blockwise_attention(q, k, v, causal=causal, block_kv=8, query_scale=scale)
        return jnp.sum(o * do), o

    (_, want), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn.blockwise_attention(qt, kt, vt, causal=causal, block_kv=8, query_scale=scale)
    _held(o, want, "o")
    got = torch.autograd.grad((o * torch.from_numpy(do)).sum(), (qt, kt, vt))
    for g, w, what in zip(got, grads, ("dq", "dk", "dv")):
        _held(g, w, what, GRAD_TOL)
    assert (flash_attention.MAX_QK_DIM, flash_attention.MAX_V_DIM) == (256, 256)
    assert decode_attention.MAX_HEAD_DIM == 256


def test_the_kernel_width_contract_names_both_limits():
    q = torch.zeros((1, 4, 2, 272))
    with pytest.raises(ValueError, match="D up to 256 and a v width Dv up to 256"):
        flash_attention._check_kernel_shapes(q, q, q[..., :256])
    with pytest.raises(ValueError, match="got D=256 and Dv=272"):
        flash_attention._check_kernel_shapes(q[..., :256], q[..., :256], q)
    flash_attention._check_kernel_shapes(q[..., :256], q[..., :256], q[..., :256])
    # K11's: D and Dv up to 256 alike
    with pytest.raises(ValueError, match="D, Dv <= 256"):
        decode_attention.check_kernel_shapes(272, 256, 2, 8)
    with pytest.raises(ValueError, match="got D=256, Dv=272"):
        decode_attention.check_kernel_shapes(256, 272, 2, 8)
    decode_attention.check_kernel_shapes(256, 256, 2, 8)


# ------------------------------------------------------------------ the transformer

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


@pytest.fixture(scope="module")
def smoke_case():
    """The deepseek smoke transformer's JAX results: the loss and its
    gradients, prefill, and STEPS decode steps over prefill's cache grown."""
    cfg = tds.make_smoke_config()
    jcfg = jds.make_smoke_config()
    jp = jax.tree.map(np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    weight = np.array([1.0, 0.5], np.float32)
    steps = rng.integers(0, cfg.vocab, size=(STEPS, B, 1)).astype(np.int32)
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
    return {"cfg": cfg, "jcfg": jcfg, "jp": jp, "tokens": tokens, "weight": weight,
            "steps": steps, "loss": float(loss), "parts": {k: float(v) for k, v in parts.items()},
            "grads": params_from_jax(jax.tree.map(np.asarray, grads)),
            "logits": np.asarray(logits), "cache": jax.tree.map(np.asarray, cache),
            "grown": grown, "dlogits": dlogits, "dcache": jax.tree.map(np.asarray, dcache)}


def test_smoke_transformer_loss_and_every_gradient_match_jax(smoke_case):
    params = {k: v.requires_grad_() for k, v in params_from_jax(smoke_case["jp"]).items()}
    mine = ttr.init_params(smoke_case["cfg"], torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    batch = {"tokens": torch.from_numpy(smoke_case["tokens"]),
             "weight": torch.from_numpy(smoke_case["weight"])}
    loss, parts = ttr.loss_fn(smoke_case["cfg"], params, batch)
    np.testing.assert_allclose(float(loss.detach()), smoke_case["loss"], rtol=TOL)
    for k in ("lm_loss", "aux_loss"):
        np.testing.assert_allclose(float(parts[k].detach()), smoke_case["parts"][k], rtol=TOL,
                                   atol=1e-7)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert set(params) == set(smoke_case["grads"])
    for name, g in zip(params, grads):
        _held(g, smoke_case["grads"][name].numpy(), name, GRAD_TOL)


def test_smoke_transformer_prefill_and_decode_match_jax(smoke_case):
    params = params_from_jax(smoke_case["jp"])
    bundle = model_zoo.build_model(smoke_case["cfg"], device="cpu")
    logits, cache = bundle.prefill(params, {"tokens": torch.from_numpy(smoke_case["tokens"])})
    _held(logits, smoke_case["logits"], "prefill logits")
    assert {p: set(kv) for p, kv in cache.items()} == \
        {"dense_layers": {"ckv", "krope"}, "layers": {"ckv", "krope"}}
    for prefix, kv in smoke_case["cache"].items():
        for name, want in kv.items():
            _held(cache[prefix][name], want, f"prefill cache {prefix}.{name}")
    empty = bundle.init_cache(B, S + STEPS)
    assert {p: {n: tuple(t.shape) for n, t in kv.items()} for p, kv in empty.items()} == \
        {p: {n: a.shape for n, a in kv.items()} for p, kv in smoke_case["grown"].items()}
    cache = _torch_cache(smoke_case["grown"])
    for i in range(STEPS):
        logits, cache = bundle.decode_step(params, cache,
                                           torch.from_numpy(smoke_case["steps"][i]), S + i)
        _held(logits, smoke_case["dlogits"][i], f"decode step {i}")
    for prefix, kv in smoke_case["dcache"].items():
        for name, want in kv.items():
            _held(cache[prefix][name], want, f"decode cache {prefix}.{name}")


def test_prefill_cache_clamp_on_the_compressed_caches_is_the_references(smoke_case):
    """A decode step straight after prefill (caches as long as the prompt)
    writes c_kv and k_rope at pos clamped into the cache: the last slot, in
    both packages (F6)."""
    cfg, jcfg, jp = smoke_case["cfg"], smoke_case["jcfg"], smoke_case["jp"]
    tokens = smoke_case["tokens"][:, :6]
    nxt = np.full((B, 1), 3, np.int32)
    _, jcache = jtr.prefill(jcfg, jp, tokens)
    want, jcache = jtr.decode_step(jcfg, jp, jcache, nxt, jnp.int32(6))
    params = params_from_jax(jp)
    _, cache = ttr.prefill(cfg, params, torch.from_numpy(tokens))
    before = cache["layers"]["ckv"][:, :, :5].clone()
    got, cache = ttr.decode_step(cfg, params, cache, torch.from_numpy(nxt), 6)
    _held(got, np.asarray(want), "clamped step")
    assert torch.equal(cache["layers"]["ckv"][:, :, :5], before)
    for prefix in ("dense_layers", "layers"):
        for name in ("ckv", "krope"):
            _held(cache[prefix][name], np.asarray(jcache[prefix][name]),
                  f"clamped cache {prefix}.{name}")


def test_a_window_changes_nothing_on_the_mla_forward(smoke_case):
    """F7: the reference passes no window to mla_forward, so a config's
    window leaves the loss as it was, in both packages, bit for bit in the
    port."""
    cfg = dataclasses.replace(smoke_case["cfg"], window=4)
    jcfg = dataclasses.replace(smoke_case["jcfg"], window=4)
    batch = {"tokens": jnp.asarray(smoke_case["tokens"])}
    want = float(jtr.loss_fn(jcfg, smoke_case["jp"], batch)[0])
    assert want == float(jtr.loss_fn(smoke_case["jcfg"], smoke_case["jp"], batch)[0])
    params = params_from_jax(smoke_case["jp"])
    tb = {"tokens": torch.from_numpy(smoke_case["tokens"])}
    got = ttr.loss_fn(cfg, params, tb)[0]
    assert torch.equal(got, ttr.loss_fn(smoke_case["cfg"], params, tb)[0])
    np.testing.assert_allclose(float(got), want, rtol=TOL)


RING_STEPS = 7  # past the ring cache's 4 slots


def test_ring_decode_writes_at_pos_clamped_as_the_reference(smoke_case):
    """F7: init_cache(ring=True) sizes a windowed config's cache at the
    window (4 slots here), and mla_decode writes at pos unwrapped, so past
    the window every step writes the last slot and attends over all 4, in
    both packages (the dense layer's cache stays seq_len long)."""
    cfg = dataclasses.replace(smoke_case["cfg"], window=4)
    jcfg = dataclasses.replace(smoke_case["jcfg"], window=4)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (RING_STEPS, B, 1)).astype(np.int32)
    jcache = jtr.init_cache(jcfg, B, 16, ring=True)
    cache = ttr.init_cache(cfg, B, 16, ring=True, device="cpu")
    assert cache["layers"]["ckv"].shape == (2, B, 4, 64) == jcache["layers"]["ckv"].shape
    assert cache["dense_layers"]["krope"].shape == (1, B, 16, 16)
    jdecode = jax.jit(lambda p, c, t, pos: jtr.decode_step(jcfg, p, c, t, pos, ring=True))
    params = params_from_jax(smoke_case["jp"])
    for i in range(RING_STEPS):
        want, jcache = jdecode(smoke_case["jp"], jcache, tokens[i], jnp.int32(i))
        got, cache = ttr.decode_step(cfg, params, cache, torch.from_numpy(tokens[i]), i,
                                     ring=True)
        _held(got, np.asarray(want), f"ring step {i}")
    for prefix in ("dense_layers", "layers"):
        for name in ("ckv", "krope"):
            _held(cache[prefix][name], np.asarray(jcache[prefix][name]),
                  f"ring cache {prefix}.{name}")


# ------------------------------------------------------------------ the round

def test_one_fedavg_round_of_the_smoke_task_matches_the_reference_engine():
    """One round (K = 2, one local step, FVN on) of task_for_config(the
    smoke config) against the reference's jitted engine over the same
    parameters and batch; then the perplexity evaluation."""
    jtask = jax_task_for_config(jds.make_smoke_config())
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
    task = task_for_config(tds.make_smoke_config())
    assert (task.kind, task.quality_metric) == (jtask.kind, jtask.quality_metric) == ("moe", "ppl")
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


def test_a_round_keeps_each_leafs_dtype_in_a_mixed_tree():
    """deepseek's tree at width is bf16 beside the fp32 MoE router: one
    round (FVN on, the engine's per-leaf passes: the normal draw, the
    deltas, the weighted mean, the server's Adam) on the smoke config with
    bf16 parameters keeps every leaf's dtype, finite, and moves the fp32
    router and the bf16 weights (a bf16 norm scale of 1 may round back)."""
    cfg = dataclasses.replace(tds.make_smoke_config(), dtype="bfloat16", param_dtype="bfloat16")
    task = task_for_config(cfg)
    params = task.init_params(torch.Generator().manual_seed(0))
    assert params["layers.moe.router"].dtype == torch.float32
    assert {t.dtype for k, t in params.items() if k != "layers.moe.router"} == {torch.bfloat16}
    corpus = task.make_corpus(0)
    from repro_torch.data import FederatedSampler

    batch = FederatedSampler(corpus, K, B, data_limit=LIMIT, seed=0).next_round().engine_batch()
    engine = build_round_engine(FederatedPlan(**{**PLAN, "server_optimizer": "adam",
                                                 "server_lr": 1e-3},
                                              fvn=FVNConfig(enabled=True, std=0.01)),
                                task, seed=1)
    state, metrics = engine.step(engine.init_state(params),
                                 {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    assert np.isfinite(metrics["loss"])
    for name, p in state.params.items():
        assert p.dtype == params[name].dtype and torch.isfinite(p.float()).all(), name
    for name in ("layers.moe.router", "layers.attn.w_uk", "dense_layers.attn.wq", "embed"):
        assert not torch.equal(state.params[name], params[name]), name
