"""The port's RWKV-6 stack (``repro_torch/models/rwkv.py``, the RWKV model
of ``models/model_zoo.py``) and K12's plain versions against the JAX
package's, JAX's parameters carried across by ``params_from_jax`` (the
stacked layout), in fp32.

- K12's plain forward and backward (``ref.wkv6_fwd_ref``,
  ``ref.wkv6_bwd_ref`` through ``WKV6Function``) against the reference's
  scan step (``repro/models/rwkv.py:126-131``) run by its ``chunked_scan``
  and differentiated by ``jax.vjp``: from a zero state inside one
  checkpoint chunk, and from a given state across two;
- at rwkv6-1.6b's smoke config (the ``lm-rwkv`` task's ``rwkv-tiny`` is
  held to the reference by its FedAvg round, ``test_torch_lm_tasks.py``):
  the final hidden state, the loss and every leaf's
  gradient, prefill's logits and state, and decode steps over prefill's
  state; the port's decode from a zero state against its prefill (the
  reference's ``test_rwkv_streaming_equals_batch``, atol 1e-5);
- the configs field for field and rwkv6-1.6b's 1,584,091,136 parameters on
  the meta device in JAX's leaf order and shapes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_1p6b as jrwkv
from repro.core.task import get_task as jax_get_task
from repro.models import model_zoo as jzoo
from repro.models import rwkv as jr
from repro.models.layers import chunked_scan as jax_chunked_scan
from repro_torch.configs import rwkv6_1p6b as trwkv
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import jax_leaf_order
from repro_torch.core.task import get_task
from repro_torch.kernels import ref
from repro_torch.kernels.wkv6 import CHUNK, WKV6Function, wkv6
from repro_torch.models import model_zoo as tzoo

# K12's plain versions against JAX's scan, relative to each output's largest
# entry: fp32 sums of the same products in another order over up to 128 steps
SCAN_TOL = 2e-6
# the model's outputs (hidden ~4, logits ~3, states) relative to their largest
# entry (at least 1): two layers, a vocab-wide product
TOL = 1e-5
# each gradient relative to its leaf's largest entry (at least 1): at the smoke
# config JAX's own fp32 gradient of embed is 2.4e-5 from an fp64 run of the
# port (the port's fp32 one 1.2e-5), through two layer norms, a group norm and
# the recurrence's backward
GRAD_TOL = 5e-5
STREAM_ATOL = 1e-5        # the reference's test_rwkv_streaming_equals_batch
B, S, STEPS = 2, 16, 4
RWKV_PARAMS = 1_584_091_136


def _held(got, want, what: str, tol: float = TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, (what, err)


def _jax_wkv(r, k, v, w, u, S0):
    """The reference's step (``repro/models/rwkv.py:126-131``) through its
    ``chunked_scan`` (chunk 64), on (B, S, H, P) inputs."""
    def step(Smat, inp):
        r_t, k_t, v_t, w_t = inp
        kv = k_t[..., :, None] * v_t[..., None, :]
        y = jnp.einsum("bhp,bhpq->bhq", r_t, Smat + u[None, :, :, None] * kv)
        return w_t[..., :, None] * Smat + kv, y

    Sn, ys = jax_chunked_scan(step, S0, tuple(a.swapaxes(0, 1) for a in (r, k, v, w)), chunk=64)
    return ys.swapaxes(0, 1), Sn


def _vjp(fn):
    """(primals..., cotangents...) -> (fn(*primals), its vjp at the
    cotangents), one cotangent for each of fn's two outputs."""
    def run(*args):
        out, vjp = jax.vjp(fn, *args[:-2])
        return out, vjp(tuple(args[-2:]))

    return run


@pytest.mark.parametrize("shape,from_state", [((2, 12, 2, 16), False), ((2, 128, 3, 8), True)],
                         ids=["one-chunk-from-zero", "two-chunks-from-a-state"])
def test_k12_plain_versions_are_the_references_scan_step(shape, from_state):
    Bs, Ss, H, P = shape
    rng = np.random.default_rng(3)
    r, k, v = (rng.normal(size=shape).astype(np.float32) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=shape) * 0.5 - 1.0)).astype(np.float32)
    u = (rng.normal(size=(H, P)) * 0.1).astype(np.float32)
    S0 = (rng.normal(size=(Bs, H, P, P)) * 0.1 if from_state
          else np.zeros((Bs, H, P, P))).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    dS = rng.normal(size=(Bs, H, P, P)).astype(np.float32)
    (y, Sn), want_grads = jax.jit(_vjp(_jax_wkv))(r, k, v, w, u, S0, dy, dS)

    ins = [torch.from_numpy(a).requires_grad_(True) for a in (r, k, v, w, u, S0)]
    ty, tS = WKV6Function.apply(*ins)
    _held(ty, y, "y", SCAN_TOL)
    _held(tS, Sn, "S_T", SCAN_TOL)
    grads = torch.autograd.grad((ty, tS), ins, (torch.from_numpy(dy), torch.from_numpy(dS)))
    for name, got, want in zip(("dr", "dk", "dv", "dw", "du", "dS0"), grads, want_grads):
        _held(got, want, name, SCAN_TOL)
    # the checkpoints are the states at 0, CHUNK, ...; the no-grad call keeps none
    _, _, ck = ref.wkv6_fwd_ref(*(torch.from_numpy(a) for a in (r, k, v, w, u, S0)), CHUNK)
    assert ck.shape == (Bs, H, -(-Ss // CHUNK), P, P)
    with torch.no_grad():
        y2, S2 = wkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u, S0)))
    assert torch.equal(y2, ty.detach()) and torch.equal(S2, tS.detach())


CONFIGS = {"rwkv6-smoke": trwkv.make_smoke_config}


def jax_config(cfg: tzoo.RWKVModelConfig) -> jzoo.RWKVModelConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["rwkv"] = jr.RWKVConfig(**dataclasses.asdict(cfg.rwkv))
    return jzoo.RWKVModelConfig(**fields)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """One config's JAX results: the forward, the loss and its gradients,
    prefill, and STEPS decode steps from prefill's state."""
    cfg = CONFIGS[request.param]()
    jcfg = jax_config(cfg)
    bundle = jzoo.build_model(jcfg)
    jp = jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    weight = np.array([1.0, 0.5], np.float32)
    steps = rng.integers(0, cfg.vocab, size=(STEPS, B, 1)).astype(np.int32)
    hidden, _ = jax.jit(lambda p, t: jzoo._rwkv_forward(jcfg, p, t))(jp, tokens)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo._rwkv_loss(jcfg, p, b), has_aux=True))(
        jp, {"tokens": jnp.asarray(tokens), "weight": jnp.asarray(weight)})
    logits, state = jax.jit(bundle.prefill)(jp, {"tokens": tokens})
    decode = jax.jit(bundle.decode_step)
    dlogits, dstate = [], state
    for i in range(STEPS):
        lg, dstate = decode(jp, dstate, steps[i], jnp.int32(S + i))
        dlogits.append(np.asarray(lg))
    return {"cfg": cfg, "jp": jp, "tokens": tokens, "weight": weight, "steps": steps,
            "hidden": np.asarray(hidden), "loss": float(loss),
            "grads": params_from_jax(jax.tree.map(np.asarray, grads)),
            "logits": np.asarray(logits), "state": jax.tree.map(np.asarray, state),
            "dlogits": dlogits, "dstate": jax.tree.map(np.asarray, dstate)}


def test_forward_loss_and_every_gradient_match_jax(case):
    cfg = case["cfg"]
    params = {k: v.requires_grad_(True) for k, v in params_from_jax(case["jp"]).items()}
    tokens = torch.from_numpy(case["tokens"]).long()
    with torch.no_grad():
        hidden, none = tzoo._rwkv_forward(cfg, params, tokens)
    assert none is None
    _held(hidden, case["hidden"], "hidden")
    bundle = tzoo.build_model(cfg, device="cpu")
    loss, aux = bundle.loss_fn(params, {"tokens": tokens,
                                        "weight": torch.from_numpy(case["weight"])})
    np.testing.assert_allclose(float(loss), case["loss"], rtol=TOL)
    assert aux["lm_loss"] is loss
    grads = torch.autograd.grad(loss, list(params.values()))
    assert set(params) == set(case["grads"])
    for name, g in zip(params, grads):
        want = case["grads"][name].numpy()
        finite = np.isfinite(want)
        assert finite.all(), name
        _held(g, want, name, GRAD_TOL)


def test_prefill_and_decode_match_jax(case):
    cfg = case["cfg"]
    params = params_from_jax(case["jp"])
    bundle = tzoo.build_model(cfg, device="cpu")
    with torch.no_grad():
        logits, state = bundle.prefill(params, {"tokens": torch.from_numpy(case["tokens"])
                                                .long()})
        _held(logits, case["logits"], "prefill logits")
        want = params_from_jax(case["state"])
        got = params_from_jax({k: _np(v) for k, v in state.items()})
        assert got.keys() == want.keys()
        for name in want:
            _held(got[name], want[name], f"prefill state {name}")
        for i in range(STEPS):
            lg, state = bundle.decode_step(params, state,
                                           torch.from_numpy(case["steps"][i]).long(), S + i)
            _held(lg, case["dlogits"][i], f"decode step {i}")
        want = params_from_jax(case["dstate"])
        got = params_from_jax({k: _np(v) for k, v in state.items()})
        for name in want:
            _held(got[name], want[name], f"decode state {name}")


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


@pytest.mark.parametrize("prompt", [0, S - STEPS], ids=["from-empty", "after-prefill"])
def test_streaming_equals_batch(case, prompt):
    """Decode token by token, from ``init_cache`` (the reference's
    ``test_rwkv_streaming_equals_batch``) or from the state a prefill over
    the first ``prompt`` tokens leaves, == prefill over all the tokens: the
    last logits and the state."""
    cfg = case["cfg"]
    params = params_from_jax(case["jp"])
    bundle = tzoo.build_model(cfg, device="cpu")
    tokens = torch.from_numpy(case["tokens"]).long()
    with torch.no_grad():
        lp, want = bundle.prefill(params, {"tokens": tokens})
        if prompt:
            _, cache = bundle.prefill(params, {"tokens": tokens[:, :prompt]})
        else:
            cache = bundle.init_cache(B, S)
        assert cache["tm"]["S"].shape == (cfg.n_layers, B, cfg.rwkv.n_heads,
                                          cfg.rwkv.head_size, cfg.rwkv.head_size)
        for t in range(prompt, S):
            lg, cache = bundle.decode_step(params, cache, tokens[:, t:t + 1], t)
    np.testing.assert_allclose(lg.numpy(), lp.numpy(), atol=STREAM_ATOL)
    got, want = params_from_jax(_np(cache)), params_from_jax(_np(want))
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=STREAM_ATOL,
                                   err_msg=name)


def test_configs_and_the_lm_rwkv_task_are_the_references_field_for_field():
    for mine, want in ((trwkv.make_config(), jrwkv.make_config()),
                       (trwkv.make_smoke_config(), jrwkv.make_smoke_config()),
                       (trwkv.make_config(n_layers=2),
                        dataclasses.replace(jrwkv.make_config(), n_layers=2))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(want)
    assert trwkv.ARCH_ID == jrwkv.ARCH_ID
    task, jtask = get_task("lm-rwkv"), jax_get_task("lm-rwkv")
    assert (task.name, task.kind, task.quality_metric) == \
        (jtask.name, jtask.kind, jtask.quality_metric) == ("lm-rwkv", "ssm", "ppl")
    assert dataclasses.asdict(task.config) == dataclasses.asdict(jtask.bundle.config)
    assert task.config.rwkv.d_ff == 64 and tzoo.RWKVModelConfig(
        "x", 1, tzoo.RWKVConfig(d_model=64), 8).rwkv.d_ff == 224


def test_rwkv6_1p6b_parameters_on_the_meta_device_are_the_references():
    """1,584,091,136 bf16 parameters in 29 leaves, in JAX's leaf order, each
    of the reference's shape (``jax.eval_shape``: no memory on either side)."""
    task = get_task("rwkv6-1.6b")
    assert task.config == trwkv.make_config() and task.kind == "ssm"
    params = tzoo._rwkv_init(task.config, torch.Generator(), device="meta")
    assert sum(t.numel() for t in params.values()) == RWKV_PARAMS
    jcfg = jrwkv.make_config()
    shapes = jax.eval_shape(lambda k: jzoo._rwkv_init(jcfg, k), jax.random.PRNGKey(0))
    paths, _ = jax.tree_util.tree_flatten_with_path(shapes)
    names = [".".join(str(p.key) for p in path) for path, _ in paths]
    assert len(params) == 29 and jax_leaf_order(params) == names
    for (_, leaf), name in zip(paths, names):
        assert tuple(params[name].shape) == leaf.shape, name
        assert params[name].dtype == torch.bfloat16 and leaf.dtype == jnp.bfloat16


def test_k12_wrapper_checks_shapes_and_takes_the_plain_version_on_the_cpu():
    from repro_torch.kernels import wkv6 as K12

    r = torch.randn(2, 5, 2, 8)
    u = torch.zeros(2, 8)
    before = (K12.FWD_LAUNCHES, K12.BWD_LAUNCHES)
    y, ST, ck = K12.wkv6_fwd(r, r, r, r.sigmoid(), u, checkpoints=True)
    K12.wkv6_bwd(r, r, r, r.sigmoid(), u, ck, torch.ones_like(r))
    assert (K12.FWD_LAUNCHES, K12.BWD_LAUNCHES) == before  # no kernel ran
    assert y.shape == r.shape and ST.shape == (2, 2, 8, 8) and ck.shape == (2, 2, 1, 8, 8)
    with pytest.raises(ValueError, match="share one"):
        K12.wkv6_fwd(r, r[:, :4], r, r, u)
    with pytest.raises(ValueError, match="u must be"):
        K12.wkv6_fwd(r, r, r, r, torch.zeros(8))
    with pytest.raises(ValueError, match="S0 must be"):
        K12.wkv6_fwd(r, r, r, r, u, torch.zeros(2, 2, 8, 4))
    with pytest.raises(ValueError, match="do not fit"):
        K12.wkv6_bwd(r, r, r, r, u, ck[:, :, :, :4], torch.ones_like(r))
    # the backward's block at every head size: 8 state entries a thread, in
    # the shared memory of one H100 block; rwkv6-1.6b's P=64 one block an SM
    for P in K12.HEAD_SIZES:
        geo = K12.bwd_geometry(P)
        assert geo["threads"] == P * P // 8 == 32 * geo["warps"] <= 1024
        assert geo["shared_bytes"] <= K12.SMEM_LIMIT
    assert K12.bwd_geometry(64)["shared_bytes"] > K12.SMEM_LIMIT // 2
    with pytest.raises(ValueError, match="P in"):
        K12.bwd_geometry(48)


@pytest.mark.parametrize("P", [16, 32, 64])
def test_k12_forward_block_at_every_head_size(P):
    """The forward's block: a block's columns (at most FWD_LINES) each over
    P/8 lanes, up to FWD_COLS columns a thread in whole warps, the blocks
    of a (b, h) covering its P columns, in the shared memory of one H100
    block."""
    from repro_torch.kernels import wkv6 as K12

    geo = K12.fwd_geometry(P)
    lines = min(P, K12.FWD_LINES)
    assert geo["threads"] * min(K12.FWD_COLS, lines * P // 256) == lines * P // 8
    assert geo["threads"] % 32 == 0
    assert geo["blocks"] * lines == P
    assert geo["shared_bytes"] <= K12.SMEM_LIMIT


def test_k12_forward_block_refuses_head_size_48():
    from repro_torch.kernels import wkv6 as K12

    with pytest.raises(ValueError, match="P in"):
        K12.fwd_geometry(48)
