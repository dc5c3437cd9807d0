"""The port's ``--arch`` registry and configs (``repro_torch/configs/``)
against the JAX package's: ``list_archs``, ``ASSIGNED``, ``get_arch``'s
error, ``SHAPES``, ``round_layout``, ``default_plan``, the batch makers'
shapes and dtypes, every ``ArchSpec``'s fields and sharding rules, each
config (full, smoke and long_500k's) field by field, each full config's
parameter count against ``jax.eval_shape``'s (the port's on the meta
device: neither side allocates), ``arch_task``'s kinds and metrics, and
the four new transformer smoke configs' forward, loss, gradients, prefill
and decode against the reference's, JAX's parameters carried across by
``params_from_jax``, in fp32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.core.task import arch_task as jax_arch_task
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtr
from repro_torch.configs import base, get_arch, list_archs, registry
from repro_torch.convert import params_from_jax
from repro_torch.core.task import arch_task
from repro_torch.models import encdec, hybrid, model_zoo, rnnt, vlm
from repro_torch.models import transformer as ttr

ARCHS = jregistry.list_archs()
# fields of the reference's configs that the port has no use for
JAX_ONLY = {"scan_unroll"}   # lax.scan's unroll factor (the RNN-T's): no scan to unroll


def _as_dict(cfg) -> dict:
    """A config's fields, nested configs as dicts, without JAX_ONLY."""
    def strip(d):
        return {k: strip(v) if isinstance(v, dict) else v for k, v in d.items()
                if k not in JAX_ONLY}

    return strip(dataclasses.asdict(cfg))


def _spec(jax_spec) -> base.P:
    """A jax PartitionSpec as the port's P."""
    return base.P(*tuple(jax_spec))


def _rules(jax_rules) -> list:
    return [(rx, _spec(sp)) for rx, sp in jax_rules]


# ------------------------------------------------------------------ registry

def test_the_registry_lists_the_references_archs_in_its_order():
    assert list_archs() == ARCHS and len(ARCHS) == 11
    assert registry.ASSIGNED == jregistry.ASSIGNED and len(registry.ASSIGNED) == 10
    assert "rnnt-librispeech" not in registry.ASSIGNED


def test_an_unknown_arch_raises_the_references_key_error():
    with pytest.raises(KeyError) as want:
        jregistry.get_arch("gpt-5")
    with pytest.raises(KeyError) as got:
        get_arch("gpt-5")
    assert str(got.value) == str(want.value)


def test_shapes_and_the_partition_spec():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert base.P(None, "model") == (None, ("model",))
    assert base.P(None, base.BAT, ("model",)) == (None, ("pod", "data"), ("model",))
    assert base.P() == () and repr(base.P("model", None)) == "P(('model',), None)"


@pytest.mark.parametrize("shape", list(jbase.SHAPES))
@pytest.mark.parametrize("engine", ["fedavg", "fedsgd"])
def test_round_layout_is_the_references(shape, engine):
    for shards in (1, 2, 4, 8, 16, 32):
        sh = base.SHAPES[shape]
        if sh.global_batch % shards:
            with pytest.raises(ValueError):
                base.round_layout(sh, shards, engine)
            continue
        assert base.round_layout(sh, shards, engine) == \
            jbase.round_layout(jbase.SHAPES[shape], shards, engine)


def test_default_plan_sets_the_references_fields():
    for engine, K in (("fedavg", 16), ("fedsgd", 4)):
        mine, want = base.default_plan(engine, K), jbase.default_plan(engine, K)
        for f in ("clients_per_round", "local_batch_size", "engine", "server_optimizer",
                  "local_steps", "client_lr", "server_lr"):
            assert getattr(mine, f) == getattr(want, f), f


def _shapes(struct: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in struct.items()}


def test_the_batch_makers_give_the_references_shapes_and_dtypes():
    """Each maker at train_4k's layout (K = 16 client shards) or its serve
    shape, on the meta device (no memory), and the batch specs."""
    from repro.configs import llava_next_mistral_7b as jl
    from repro.configs import rnnt_librispeech as jr
    from repro.configs import whisper_base as jw

    train, prefill = base.SHAPES["train_4k"], base.SHAPES["prefill_32k"]
    jtrain, jprefill = jbase.SHAPES["train_4k"], jbase.SHAPES["prefill_32k"]
    K, S, b = base.round_layout(train, 16, "fedavg")
    cases = [
        (base.lm_train_batch(train, K, S, b), jbase.lm_train_batch(jtrain, K, S, b)),
        (base.audio_train_batch(train, K, S, b, get_arch("whisper-base").make_config()),
         jbase.audio_train_batch(jtrain, K, S, b, jw.make_config())),
        (base.vlm_train_batch(train, K, S, b, get_arch("llava-next-mistral-7b").make_config()),
         jbase.vlm_train_batch(jtrain, K, S, b, jl.make_config())),
        (base.rnnt_train_batch(train, K, S, b, get_arch("rnnt-librispeech").make_config()),
         jbase.rnnt_train_batch(jtrain, K, S, b, jr.make_config())),
        (base.lm_prefill_batch(prefill), jbase.lm_prefill_batch(jprefill)),
        (base.audio_prefill_batch(prefill, get_arch("whisper-base").make_config()),
         jbase.audio_prefill_batch(jprefill, jw.make_config())),
        (base.vlm_prefill_batch(prefill, get_arch("llava-next-mistral-7b").make_config()),
         jbase.vlm_prefill_batch(jprefill, jl.make_config())),
    ]
    for mine, want in cases:
        assert all(t.device.type == "meta" for t in mine.values())
        assert _shapes(mine) == _shapes(want)
        assert base.batch_specs(mine) == {k: _spec(v) for k, v in
                                          jbase.batch_specs(want).items()}
    assert cases[2][0]["image_embeds"].shape == (K, S, b, 576, 1024)
    assert cases[2][0]["tokens"].shape == (K, S, b, 4096 - 576)


def test_the_rule_makers_are_the_references():
    for mine, want in (
            *((base.transformer_param_rules(h, kv, mla=mla, moe=moe),
               jbase.transformer_param_rules(h, kv, mla=mla, moe=moe))
              for h, kv in ((64, 8), (32, 16), (8, 4)) for mla in (False, True)
              for moe in (False, True)),
            (base.hybrid_param_rules(), jbase.hybrid_param_rules()),
            (base.rwkv_param_rules(), jbase.rwkv_param_rules()),
            (base.audio_param_rules(), jbase.audio_param_rules()),
            (base.rnnt_param_rules(), jbase.rnnt_param_rules()),
            *((mk(long), jmk(long)) for long in (False, True) for mk, jmk in (
                (base.transformer_cache_rules, jbase.transformer_cache_rules),
                (base.hybrid_cache_rules, jbase.hybrid_cache_rules),
                (base.rwkv_cache_rules, jbase.rwkv_cache_rules),
                (base.audio_cache_rules, jbase.audio_cache_rules))),
            (base.prefix_rules("lm/", base.transformer_param_rules(32, 8)),
             jbase.prefix_rules("lm/", jbase.transformer_param_rules(32, 8)))):
        assert mine == _rules(want)


# ------------------------------------------------------------------ the archs

@pytest.mark.parametrize("arch_id", ARCHS)
def test_each_arch_spec_is_the_references(arch_id):
    """Every field of the ArchSpec, its rules, and its configs (full,
    smoke, long_500k's) field by field."""
    mine, want = get_arch(arch_id), jregistry.get_arch(arch_id)
    for f in ("arch_id", "citation", "kind", "engine", "long_policy", "skip_notes"):
        assert getattr(mine, f) == getattr(want, f), f
    assert (mine.make_long_config is None) == (want.make_long_config is None)
    assert list(mine.param_rules) == _rules(want.param_rules)
    assert list(mine.cache_rules) == _rules(want.cache_rules)
    assert type(mine.make_config()).__name__ == type(want.make_config()).__name__
    for shape in ("train_4k", "long_500k"):
        assert _as_dict(mine.config_for(shape)) == _as_dict(want.config_for(shape)), shape
    assert _as_dict(mine.make_smoke_config()) == _as_dict(want.make_smoke_config())


def _meta_params(cfg) -> dict:
    """The port's parameters of ``cfg`` on the meta device."""
    gen = torch.Generator()
    if isinstance(cfg, ttr.TransformerConfig):
        return ttr.init_params(cfg, gen, device="meta")
    if isinstance(cfg, vlm.VLMConfig):
        return vlm.init_params(cfg, gen, device="meta")
    if isinstance(cfg, hybrid.HybridConfig):
        return hybrid.init_params(cfg, gen, device="meta")
    if isinstance(cfg, model_zoo.RWKVModelConfig):
        return model_zoo._rwkv_init(cfg, gen, device="meta")
    if isinstance(cfg, rnnt.RNNTConfig):
        return dict(rnnt.RNNT(cfg).named_parameters())   # a meta module
    raise TypeError(type(cfg))


# the full configs' parameter counts (jax.eval_shape of the reference's init)
FULL_PARAMS = {
    "llava-next-mistral-7b": 7_262_711_808,
    "qwen3-8b": 8_190_735_360,
    "rwkv6-1.6b": 1_584_091_136,
    "whisper-base": 70_857_216,
}


@pytest.mark.parametrize("arch_id", ARCHS)
def test_each_full_config_has_the_references_parameters(arch_id):
    """Every leaf's name, shape and dtype and the count, neither side
    allocating: the reference's ``jax.eval_shape`` of its init, the port's
    init on the meta device (the enc-dec's by ``encdec.param_count``)."""
    cfg, jcfg = get_arch(arch_id).make_config(), jregistry.get_arch(arch_id).make_config()
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    paths, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want = {".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in paths}
    n_want = sum(int(np.prod(s)) for s, _ in want.values())
    if isinstance(cfg, encdec.EncDecConfig):
        n = encdec.param_count(cfg)
    else:
        params = _meta_params(cfg)
        n = sum(t.numel() for t in params.values())
        if not isinstance(cfg, rnnt.RNNTConfig):   # the RNN-T's module names its own
            assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
                    for k, t in params.items()} == want
    assert n == n_want
    if arch_id in FULL_PARAMS:
        assert n == FULL_PARAMS[arch_id]


def test_llava_at_four_layers_is_the_card_runs_size():
    """The card's llava-next-mistral-7b: full width, 4 of its 32 layers."""
    cfg = get_arch("llava-next-mistral-7b").make_config()
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, n_layers=4))
    assert sum(t.numel() for t in _meta_params(cfg).values()) == 1_155_575_808


@pytest.mark.parametrize("arch_id", ARCHS)
def test_arch_task_is_the_references(arch_id):
    """arch_task of each id: the smoke config's task, its kind and metric as
    the reference's, or the reference's ValueError (the VLM)."""
    try:
        want = jax_arch_task(arch_id)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            arch_task(arch_id)
        assert str(got.value) == str(e) and arch_id == "llava-next-mistral-7b"
        return
    task = arch_task(arch_id)
    assert (task.name, task.kind, task.quality_metric) == \
        (arch_id, want.kind, want.quality_metric)
    assert _as_dict(task.config) == _as_dict(get_arch(arch_id).make_smoke_config())


# ------------------------------------------------------- the new smoke models

# Relative to the largest entry of each output (at least 1), as
# tests/test_torch_transformer.py: fp32 sums of the same products in another
# order, through 2 layers and a vocab-wide product
TOL = 1e-5
GRAD_TOL = 1e-5
B, S, STEPS = 2, 24, 3      # 24 positions: gemma3's local window of 16 acts
NEW = ("command-r-35b", "deepseek-67b", "gemma3-4b", "phi3.5-moe-42b-a6.6b")


def _held(got: torch.Tensor, want, what: str, tol: float = TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, (what, err)


def _grow(cache, total: int):
    out = {}
    for prefix, kv in cache.items():
        out[prefix] = {}
        for name, a in kv.items():
            a = np.asarray(a)
            z = np.zeros(a.shape[:2] + (total,) + a.shape[3:], a.dtype)
            z[:, :, :a.shape[2]] = a
            out[prefix][name] = z
    return out


@pytest.mark.parametrize("arch_id", NEW)
def test_new_smoke_transformer_matches_jax(arch_id):
    """The smoke config's forward (the final hidden), loss (a row weighted
    0.5) and every gradient, prefill's logits and cache, and STEPS decode
    steps over prefill's cache grown: command-r's parallel blocks with
    LayerNorm, deepseek-67b's llama layers, gemma3's (1 + scale) RMSNorm,
    embedding scale, gelu_tanh, qk_norm and a local window with a global
    layer, phi's top-2 MoE."""
    cfg, jcfg = get_arch(arch_id).make_smoke_config(), \
        jregistry.get_arch(arch_id).make_smoke_config()
    jp = jax.tree.map(np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(sum(map(ord, arch_id)))
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

    params = {k: v.requires_grad_() for k, v in params_from_jax(jp).items()}
    tt = torch.from_numpy(tokens)
    _held(ttr.forward(cfg, params, tt)[0], hidden, "forward")
    tloss, tparts = ttr.loss_fn(cfg, params, {"tokens": tt, "weight": torch.from_numpy(weight)})
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=TOL)
    for k in ("lm_loss", "aux_loss"):
        np.testing.assert_allclose(float(tparts[k].detach()), float(parts[k]), rtol=TOL,
                                   atol=1e-7)
    want_grads = params_from_jax(jax.tree.map(np.asarray, grads))
    got_grads = torch.autograd.grad(tloss, list(params.values()))
    assert set(params) == set(want_grads)
    for name, g in zip(params, got_grads):
        _held(g, want_grads[name].numpy(), name, GRAD_TOL)

    params = params_from_jax(jp)
    bundle = model_zoo.build_model(cfg, device="cpu")
    with torch.no_grad():
        tlogits, tcache = bundle.prefill(params, {"tokens": tt})
        _held(tlogits, logits, "prefill logits")
        for prefix, kv in jax.tree.map(np.asarray, cache).items():
            for name, want in kv.items():
                _held(tcache[prefix][name], want, f"prefill cache {prefix}.{name}")
        full = bundle.init_cache(B, S + STEPS)
        for prefix, kv in tcache.items():
            for name, t in kv.items():
                full[prefix][name][:, :, :S].copy_(t)
        for i in range(STEPS):
            tl, full = bundle.decode_step(params, full, torch.from_numpy(steps[i]), S + i)
            _held(tl, dlogits[i], f"decode step {i}")
    for prefix, kv in jax.tree.map(np.asarray, dcache).items():
        for name, want in kv.items():
            _held(full[prefix][name], want, f"decode cache {prefix}.{name}")
