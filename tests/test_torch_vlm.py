"""The port's VLM (``repro_torch/models/vlm.py``) against the JAX package's,
at llava-next-mistral-7b's smoke config (2 layers, d_model 128, a window of
32, 8 image tokens of 48) with 40 text tokens, so that 48 positions let the
window act. JAX's parameters are carried across by ``params_from_jax``, in
fp32 on the CPU: ``project``, the loss and every gradient (one row weighted
0), prefill's logits and cache, decode steps over prefill's cache grown
(F6), one FedAvg round with FVN on through both packages'
``make_round_step`` (the VLM has no federated task in either), the model
bundle's kind and devices, and the task registry's refusal. Every JAX draw
runs with the non-partitionable threefry (the pinned jax's default), set
and restored around it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llava_next_mistral_7b as jllava
from repro.core import FederatedPlan as JaxPlan
from repro.core import FVNConfig as JaxFVN
from repro.core import init_server_state as jax_init_state
from repro.core import make_round_step as jax_round_step
from repro.core.task import arch_task as jax_arch_task
from repro.core.task import task_for_config as jax_task_for_config
from repro.models import vlm as jvlm
from repro_torch.configs import llava_next_mistral_7b as tllava
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import jax_leaf_order
from repro_torch.core.fedavg import init_server_state, make_round_step
from repro_torch.core.plan import FederatedPlan, FVNConfig
from repro_torch.core.task import arch_task, task_for_config
from repro_torch.models import model_zoo
from repro_torch.models import vlm as tvlm

# Relative to the largest entry of each output (at least 1), as
# tests/test_torch_transformer.py: fp32 sums of the same products in another
# order, through 2 layers, the projector and a vocab-wide product
TOL = 1e-5
GRAD_TOL = 1e-5
B, S_TEXT, STEPS = 2, 40, 4
WEIGHT = np.array([1.0, 0.0], np.float32)   # the second row carries no loss
K, LOCAL = 2, 2                              # two clients of two local steps at b = B
ROUND_RTOL = 1e-5                            # the round's loss and delta norm
PARAM_TOL = 1e-5                             # each leaf after the round, of its largest entry
PLAN = dict(clients_per_round=K, local_batch_size=B, client_lr=0.05,
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


def _batch(rng, cfg, lead=()):
    return {"image_embeds": rng.standard_normal(lead + (B, cfg.n_img_tokens, cfg.vit_dim))
            .astype(np.float32),
            "tokens": rng.integers(0, cfg.lm.vocab, lead + (B, S_TEXT)).astype(np.int32)}


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
def case():
    """The reference's smoke VLM: parameters, a batch, the projection, the
    loss and its gradients, prefill and STEPS decode steps over its cache
    grown to n_img + 40 + STEPS slots; all jitted."""
    jcfg = jllava.make_smoke_config()
    jp = jax.tree.map(np.asarray, jvlm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(33)
    batch = {**_batch(rng, jcfg), "weight": WEIGHT}
    steps = rng.integers(0, jcfg.lm.vocab, (STEPS, B, 1)).astype(np.int32)
    proj = jax.jit(lambda p, x: jvlm.project(p, jcfg, x))(jp, batch["image_embeds"])
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jvlm.loss_fn(jcfg, p, b), has_aux=True))(jp, batch)
    prompt = {k: batch[k] for k in ("image_embeds", "tokens")}
    logits, cache = jax.jit(lambda p, b: jvlm.prefill(jcfg, p, b))(jp, prompt)
    n = jcfg.n_img_tokens + S_TEXT
    grown = _grow(cache, n + STEPS)
    jdecode = jax.jit(lambda p, c, t, pos: jvlm.decode_step(jcfg, p, c, t, pos))
    dcache, dlogits = jax.tree.map(jnp.asarray, grown), []
    for i in range(STEPS):
        lg, dcache = jdecode(jp, dcache, steps[i], jnp.int32(n + i))
        dlogits.append(np.asarray(lg))
    return {"jcfg": jcfg, "cfg": tllava.make_smoke_config(), "jp": jp, "batch": batch,
            "steps": steps, "proj": np.asarray(proj), "loss": float(loss),
            "parts": {k: float(v) for k, v in parts.items()},
            "grads": params_from_jax(jax.tree.map(np.asarray, grads)),
            "logits": np.asarray(logits), "cache": jax.tree.map(np.asarray, cache),
            "grown": grown, "dlogits": dlogits, "dcache": jax.tree.map(np.asarray, dcache)}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_config_and_init_are_the_references(case):
    """The smoke config field by field; the port's init draws the
    reference's leaves (names, shapes, dtypes), ``lm.*`` then
    ``projector.*`` in JAX's flatten order."""
    assert dataclasses.asdict(case["cfg"]) == dataclasses.asdict(case["jcfg"])
    mine = tvlm.init_params(case["cfg"], torch.Generator().manual_seed(0))
    want = params_from_jax(case["jp"])
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    paths, _ = jax.tree_util.tree_flatten_with_path(case["jp"])
    names = [".".join(str(p.key) for p in path) for path, _ in paths]
    assert jax_leaf_order(mine) == names
    assert names[-4:] == ["projector.b1", "projector.b2", "projector.w1", "projector.w2"]


def test_project_matches_jax(case):
    params = params_from_jax(case["jp"])
    got = tvlm.project(params, case["cfg"], torch.from_numpy(case["batch"]["image_embeds"]))
    _held(got, case["proj"], "projection")


def test_loss_and_every_gradient_match_jax(case):
    """The text-only loss (a row weighted 0) and the gradient of every leaf;
    the projector's are nonzero: the image positions carry no loss, but
    reach it through attention."""
    params = {k: v.requires_grad_() for k, v in params_from_jax(case["jp"]).items()}
    loss, parts = tvlm.loss_fn(case["cfg"], params, _torch(case["batch"]))
    np.testing.assert_allclose(float(loss.detach()), case["loss"], rtol=TOL)
    for k in ("lm_loss", "aux_loss"):
        np.testing.assert_allclose(float(parts[k].detach()), case["parts"][k], rtol=TOL,
                                   atol=1e-7)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert set(params) == set(case["grads"])
    for name, g in zip(params, grads):
        _held(g, case["grads"][name].numpy(), name, GRAD_TOL)
    for name in ("projector.w1", "projector.w2", "projector.b1", "projector.b2"):
        assert float(case["grads"][name].abs().max()) > 0.0, name


def test_the_window_acts_on_the_loss(case):
    """48 positions against a window of 32: the loss with the window differs
    from the same model's without it, in both packages."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    params = params_from_jax(case["jp"])
    full = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, window=None))
    jfull = dataclasses.replace(jcfg, lm=dataclasses.replace(jcfg.lm, window=None))
    got = float(tvlm.loss_fn(full, params, _torch(case["batch"]))[0])
    want = float(jax.jit(lambda p, b: jvlm.loss_fn(jfull, p, b)[0])(case["jp"], case["batch"]))
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert abs(got - case["loss"]) > 1e-4 * abs(case["loss"])


def test_prefill_and_decode_over_the_grown_cache_match_jax(case):
    """Prefill over the image and the prompt (a cache as long as both, F6),
    the cache copied into init_cache's zeros, STEPS decode steps past it;
    through the model bundle on the CPU."""
    params = params_from_jax(case["jp"])
    bundle = model_zoo.build_model(case["cfg"], device="cpu")
    assert bundle.kind == "vlm"
    prompt = _torch({k: case["batch"][k] for k in ("image_embeds", "tokens")})
    logits, cache = bundle.prefill(params, prompt)
    _held(logits, case["logits"], "prefill logits")
    n = case["cfg"].n_img_tokens + S_TEXT
    for prefix, kv in case["cache"].items():
        for name, want in kv.items():
            assert cache[prefix][name].shape[2] == n
            _held(cache[prefix][name], want, f"prefill cache {prefix}.{name}")
    full = bundle.init_cache(B, n + STEPS)
    for prefix, kv in cache.items():
        for name, t in kv.items():
            full[prefix][name][:, :, :n].copy_(t)
    for prefix, kv in case["grown"].items():
        for name, want in kv.items():
            assert full[prefix][name].shape == want.shape
            assert not full[prefix][name][:, :, n:].any()
    for i in range(STEPS):
        logits, full = bundle.decode_step(params, full, torch.from_numpy(case["steps"][i]),
                                          n + i)
        _held(logits, case["dlogits"][i], f"decode step {i}")
    for prefix, kv in case["dcache"].items():
        for name, want in kv.items():
            _held(full[prefix][name], want, f"decode cache {prefix}.{name}")


def test_the_bundle_puts_parameters_and_caches_on_its_device(case):
    bundle = model_zoo.build_model(case["cfg"], device="meta")
    params = bundle.init(torch.Generator().manual_seed(0))
    assert all(t.device.type == "meta" for t in params.values())
    assert bundle.param_count(params) == sum(int(np.size(a)) for a in
                                             jax.tree.leaves(case["jp"]))
    assert bundle.init_cache(B, 16)["layers"]["k"].device.type == "meta"


def test_one_fedavg_round_with_fvn_matches_the_reference(case):
    """One round (K = 2, 2 local steps, b = 2, FVN 0.01) through both
    packages' make_round_step over the bundle's loss, as the reference's dry
    run trains the VLM: the round's loss and delta norm, and every leaf
    after it. FVN's per-leaf keys follow JAX's leaf order, so a slip in it
    shows here."""
    jcfg = case["jcfg"]
    rng = np.random.default_rng(34)
    batch = _batch(rng, jcfg, (K, LOCAL))
    batch["weight"] = np.ones((K, LOCAL, B), np.float32)
    batch["weight"][1, 1, 0] = 0.0

    def run():
        plan = JaxPlan(**PLAN, fvn=JaxFVN(enabled=True, std=0.01))
        loss = lambda p, b, rng=None: jvlm.loss_fn(jcfg, p, b, rng)  # noqa: E731
        step = jax.jit(jax_round_step(loss, plan, jax.random.PRNGKey(5)))
        state, m = step(jax_init_state(plan, case["jp"]), jax.tree.map(jnp.asarray, batch))
        return {k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, state.params)

    jm, after = _non_partitionable(run)
    bundle = model_zoo.build_model(case["cfg"], device="cpu")
    plan = FederatedPlan(**PLAN, fvn=FVNConfig(enabled=True, std=0.01))
    state, m = make_round_step(bundle.loss_fn, plan, 5)(
        init_server_state(plan, params_from_jax(case["jp"])), _torch(batch))
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=ROUND_RTOL)
    np.testing.assert_allclose(m["delta_norm"], jm["delta_norm"], rtol=ROUND_RTOL)
    assert m["examples"] == jm["examples"] == float(batch["weight"].sum())
    want = params_from_jax(after)
    assert set(state.params) == set(want)
    for name, p in state.params.items():
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=PARAM_TOL * scale,
                                   rtol=0, err_msg=name)


def test_task_for_config_and_arch_task_raise_the_references_error(case):
    """The VLM has no federated task in either package: the speaker corpus
    has no images."""
    with pytest.raises(ValueError) as want:
        jax_task_for_config(case["jcfg"])
    with pytest.raises(ValueError) as got:
        task_for_config(case["cfg"])
    assert str(got.value) == str(want.value)
    assert "no federated task adapter for model kind 'vlm'" in str(got.value)
    with pytest.raises(ValueError) as jarch:
        jax_arch_task(tllava.ARCH_ID)
    with pytest.raises(ValueError) as arch:
        arch_task(tllava.ARCH_ID)
    assert str(arch.value) == str(jarch.value) == str(want.value)
