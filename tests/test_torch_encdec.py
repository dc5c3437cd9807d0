"""The port's Whisper-style enc-dec (``repro_torch/models/encdec.py``)
against the JAX package's at whisper-base's smoke config, JAX's parameters
carried across by ``params_from_jax``: ``encode``, ``loss_fn``, ``prefill``
and ``decode_step`` in fp32 and bf16 compute; the decode step's clamp of a
position past the cache (F6); decode over a cache copied from ``prefill``
against ``prefill`` over the longer prefix, in both packages; the model
bundle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_base as jwb
from repro.models import encdec as jencdec
from repro_torch.configs import whisper_base as twb
from repro_torch.convert import params_from_jax
from repro_torch.models import encdec as tencdec
from repro_torch.models import model_zoo
from repro_torch.models.rnnt import RNNTConfig

# Relative to the largest entry of each output (encoder states ~4, logits
# ~3). fp32: the same ops in another summation order, through 2+2 layers
# and a vocab-wide product (about 1e-6 seen). bf16 compute (fp32
# parameters): both sides round each op's output to bf16 (8 bits) at other
# places, about one bf16 ulp of the largest entry (about 7e-3 seen).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, T, U = 2, 24, 6


def _configs(dtype: str):
    tcfg = dataclasses.replace(twb.make_smoke_config(), dtype=dtype)
    jcfg = dataclasses.replace(jwb.make_smoke_config(), dtype=dtype)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return tcfg, jcfg


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jencdec.init_params(jwb.make_smoke_config(),
                                                      jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp)


def _data(seed: int, u: int = U, t: int = T):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, t, 64)).astype(np.float32)
    tokens = rng.integers(0, 128, size=(B, u)).astype(np.int32)
    return frames, tokens


def _held(got: torch.Tensor, want, dtype: str, what: str):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= TOL[dtype], (what, err)


def test_parameters_keep_the_reference_layout(params):
    jp, tp = params
    gen = torch.Generator().manual_seed(0)
    own = tencdec.init_params(twb.make_smoke_config(), gen)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert tp["enc_layers.attn.wq"].shape == (2, 64, 64)
    assert tencdec.param_count(twb.make_smoke_config()) == sum(v.numel() for v in tp.values())
    full = jax.eval_shape(lambda k: jencdec.init_params(jwb.make_config(), k),
                          jax.random.PRNGKey(0))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full))
    assert tencdec.param_count(twb.make_config()) == n == 70_857_216
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(full))
    assert twb.make_config().pdtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_loss_match_jax(params, dtype):
    jp, tp = params
    tcfg, jcfg = _configs(dtype)
    frames, tokens = _data(1)
    enc_j = jencdec.encode(jcfg, jp, jnp.asarray(frames))
    enc_t = tencdec.encode(tcfg, tp, torch.from_numpy(frames))
    assert enc_t.dtype == tcfg.cdtype and tuple(enc_t.shape) == (B, T, 64)
    _held(enc_t, enc_j, dtype, "encode")
    w = np.array([1.0, 0.5], np.float32)
    for weight in (None, w):
        jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
        tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}
        if weight is not None:
            jb["weight"], tb["weight"] = jnp.asarray(weight), torch.from_numpy(weight)
        jl, _ = jencdec.loss_fn(jcfg, jp, jb)
        tl, aux = tencdec.loss_fn(tcfg, tp, tb)
        assert aux["lm_loss"] is tl and tl.dtype == torch.float32
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL[dtype])


def _grown(cache: dict, total: int, cfg) -> dict:
    """``prefill``'s cache copied into ``init_cache(B, total)`` (torch)."""
    full = tencdec.init_cache(cfg, B, total, device="cpu")
    n = cache["self_k"].shape[2]
    for name in ("self_k", "self_v"):
        full[name][:, :, :n] = cache[name]
    for name in ("cross_k", "cross_v"):
        full[name].copy_(cache[name])
    return full


def _grown_jax(cache: dict, total: int, cfg) -> dict:
    full = jencdec.init_cache(cfg, B, total)
    n = cache["self_k"].shape[2]
    return {"self_k": full["self_k"].at[:, :, :n].set(cache["self_k"]),
            "self_v": full["self_v"].at[:, :, :n].set(cache["self_v"]),
            "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_jax(params, dtype):
    jp, tp = params
    tcfg, jcfg = _configs(dtype)
    frames, tokens = _data(2)
    jl, jc = jencdec.prefill(jcfg, jp, jnp.asarray(frames), jnp.asarray(tokens))
    tl, tc = tencdec.prefill(tcfg, tp, torch.from_numpy(frames), torch.from_numpy(tokens))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 128)
    _held(tl, jl, dtype, "prefill logits")
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        _held(tc[name], jc[name], dtype, name)
    jc, tc = _grown_jax(jc, 12, jcfg), _grown(tc, 12, tcfg)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for pos in range(U, U + 3):  # the same fed tokens on both sides
        jl, jc = jencdec.decode_step(jcfg, jp, jc, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32))
        tl, tc = tencdec.decode_step(tcfg, tp, tc, torch.from_numpy(nxt), pos)
        _held(tl, jl, dtype, f"decode logits at {pos}")
        for name in ("self_k", "self_v"):
            _held(tc[name], jc[name], dtype, f"{name} at {pos}")
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]


def test_decode_step_clamps_a_position_past_the_cache(params):
    """F6: ``dynamic_update_slice`` clamps the start, so pos 7 on a
    length-4 self cache (``prefill``'s, over a 4-token prompt) writes slot
    3, in both packages; the pos embedding and the mask still use 7."""
    jp, tp = params
    tcfg, jcfg = _configs("float32")
    frames, tokens = _data(3, u=4)
    _, jc = jencdec.prefill(jcfg, jp, jnp.asarray(frames), jnp.asarray(tokens))
    _, tc = tencdec.prefill(tcfg, tp, torch.from_numpy(frames), torch.from_numpy(tokens))
    before = tc["self_k"].clone()
    tok = np.array([[5], [9]], np.int32)
    jl, jc2 = jencdec.decode_step(jcfg, jp, jc, jnp.asarray(tok), jnp.asarray(7, jnp.int32))
    tl, tc2 = tencdec.decode_step(tcfg, tp, tc, torch.from_numpy(tok), 7)
    _held(tl, jl, "float32", "logits")
    for name in ("self_k", "self_v"):
        _held(tc2[name], jc2[name], "float32", name)
    assert torch.equal(tc2["self_k"][:, :, :3], before[:, :, :3])
    assert not torch.equal(tc2["self_k"][:, :, 3], before[:, :, 3])
    # a tensor position on the device is the same as an int
    _, tc3 = tencdec.prefill(tcfg, tp, torch.from_numpy(frames), torch.from_numpy(tokens))
    tl3, _ = tencdec.decode_step(tcfg, tp, tc3, torch.from_numpy(tok),
                                 torch.tensor(7, dtype=torch.int32))
    assert torch.equal(tl3, tl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_after_prefill_is_prefill_over_the_longer_prefix(params, dtype):
    """Decoding tokens U..U+2 over ``prefill``'s cache copied into a longer
    one gives ``prefill``'s last logits over the longer prompts, in both
    packages."""
    jp, tp = params
    tcfg, jcfg = _configs(dtype)
    frames, tokens = _data(4, u=U + 3)
    _, jc = jencdec.prefill(jcfg, jp, jnp.asarray(frames), jnp.asarray(tokens[:, :U]))
    _, tc = tencdec.prefill(tcfg, tp, torch.from_numpy(frames), torch.from_numpy(tokens[:, :U]))
    jc, tc = _grown_jax(jc, 16, jcfg), _grown(tc, 16, tcfg)
    for pos in range(U, U + 3):
        tok = tokens[:, pos:pos + 1]
        jl, jc = jencdec.decode_step(jcfg, jp, jc, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        tl, tc = tencdec.decode_step(tcfg, tp, tc, torch.from_numpy(tok), pos)
        jwant, _ = jencdec.prefill(jcfg, jp, jnp.asarray(frames), jnp.asarray(tokens[:, :pos + 1]))
        twant, _ = tencdec.prefill(tcfg, tp, torch.from_numpy(frames),
                                   torch.from_numpy(tokens[:, :pos + 1]))
        _held(tl, twant.numpy(), dtype, f"port decode vs port prefill at {pos}")
        np.testing.assert_allclose(np.asarray(jl), np.asarray(jwant),
                                   atol=TOL[dtype] * max(1.0, float(jnp.abs(jwant).max())))


def test_model_bundle_serves_on_the_cpu_when_asked(params):
    _, tp = params
    cfg = twb.make_smoke_config()
    bundle = model_zoo.build_model(cfg, device="cpu")
    assert bundle.kind == "audio" and bundle.config is cfg
    assert model_zoo.build_model(cfg).device == "cuda"
    own = bundle.init(torch.Generator().manual_seed(3))
    assert bundle.param_count(own) == tencdec.param_count(cfg)
    assert all(t.device.type == "cpu" for t in own.values())
    frames, tokens = _data(5)
    batch = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}
    logits, cache = bundle.prefill(tp, batch)
    want, _ = tencdec.prefill(cfg, tp, batch["frames"], batch["tokens"])
    assert torch.equal(logits, want)
    full = bundle.init_cache(B, 16)
    assert full["self_k"].shape == (2, B, 16, 4, 16) and full["cross_k"].shape == (2, B, 24, 4, 16)
    loss, _ = bundle.loss_fn(tp, batch)
    assert torch.isfinite(loss)


def test_model_bundle_puts_parameters_on_its_device():
    """One argument governs the bundle: parameters drawn on a CPU generator
    land on the bundle's device (``meta`` here stands in for the card)."""
    cfg = twb.make_smoke_config()
    bundle = model_zoo.build_model(cfg, device="meta")
    own = bundle.init(torch.Generator().manual_seed(3))
    assert all(t.device.type == "meta" for t in own.values())
    assert bundle.init_cache(B, 16)["self_k"].device.type == "meta"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """A stand-in for a config type the model zoo does not know (named as
    the transformer's, but not its class)."""
    name: str = "lm-tiny"


def test_model_bundle_refuses_what_is_not_ported():
    with pytest.raises(TypeError, match="unknown config type"):
        model_zoo.build_model(TransformerConfig(), device="cpu")
    # the RNN-T is ported since the task registry came: its bundle builds
    bundle = model_zoo.build_model(RNNTConfig(name="x", feat_dim=8, vocab=8), device="cpu")
    assert bundle.kind == "rnnt" and bundle.module is not None
