"""K2 (the full-sequence LSTM recurrence): the port's plain versions,
autograd Function and layer dispatch against the JAX package's Pallas
scan kernels in interpret mode, and the ``scan_chunk`` time loop.

On the CPU the port's wrappers take the plain versions, so these tests
hold the arithmetic the CUDA kernels must reproduce; ``chip_smoke.py``
holds the kernels themselves against the plain versions on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.asr.specaugment import SpecAugmentConfig as JaxSpecAug
from repro.core.task import default_corpus as jax_default_corpus
from repro.kernels.lstm_gates import lstm_scan_bwd_fused, lstm_scan_fused, lstm_scan_fused_vjp
from repro.models import lstm as jlstm
from repro.models import rnnt as jrnnt
from repro.profile import tuner as jtuner
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.task import get_task
from repro_torch.kernels import lstm_scan as K
from repro_torch.kernels import ref as tref
from repro_torch.models import lstm as tlstm
from repro_torch.models import rnnt as trnnt
from repro_torch.profile import tuner as ttuner

FWD_ATOL = 2e-6   # fp32: the same recurrence, sums over H in another order
REL_TOL = 1e-5    # gradients, relative to each one's largest entry
SHAPES = [(1, 2, 8), (5, 3, 8), (12, 2, 16), (32, 1, 8)]


def _case(S, B, H, seed):
    """The JAX tests' inputs (``tests/test_kernels.py:214-220``)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(S, B, 4 * H)).astype(np.float32) * 0.5,
            rng.normal(size=(H, 4 * H)).astype(np.float32) * 0.3,
            rng.normal(size=(B, H)).astype(np.float32) * 0.1,
            rng.normal(size=(B, H)).astype(np.float32) * 0.1)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close_rel(got, want, name):
    want = np.asarray(want, np.float64)
    denom = float(np.abs(want).max()) + 1e-30
    np.testing.assert_allclose(np.asarray(got, np.float64) / denom, want / denom,
                               atol=REL_TOL, rtol=0, err_msg=name)


@pytest.fixture
def registries(tmp_path):
    """Both packages' tuning registries on files of their own."""
    jreg = jtuner.TuningRegistry(path=str(tmp_path / "tuning.json"))
    treg = ttuner.TuningRegistry(path=str(tmp_path / "tuning_torch.json"), device_key="cpu")
    jtuner.set_registry(jreg)
    ttuner.set_registry(treg)
    try:
        yield jreg, treg
    finally:
        jtuner.set_registry(None)
        ttuner.set_registry(None)


def _dispatch(registries, jax_mode, torch_mode, min_seq=None):
    jreg, treg = registries
    jreg.set_override("lstm.scan_dispatch", jax_mode)
    treg.set_override("lstm.scan_dispatch", torch_mode)
    if min_seq is not None:
        jreg.set_override("lstm.scan_min_seq", min_seq)
        treg.set_override("lstm.scan_min_seq", min_seq)


@pytest.mark.parametrize("S,B,H", SHAPES)
def test_plain_forward_matches_pallas(S, B, H):
    xg, w, h0, c0 = _case(S, B, H, seed=S)
    ys_j, cs_j = lstm_scan_fused(*map(jnp.asarray, (xg, w, h0, c0)), interpret=True)
    ys_t, cs_t = K.lstm_scan_fwd(*_t(xg, w, h0, c0))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), atol=FWD_ATOL, rtol=0)
    assert ys_t.dtype == cs_t.dtype == torch.float32


@pytest.mark.parametrize("S,B,H", [(5, 3, 8), (12, 2, 16)])
def test_plain_forward_with_bf16_xg_keeps_the_fp32_carry(S, B, H):
    """bf16 xg: ys in bf16, cs in fp32, the h carry fp32 across steps.
    Both sides round the same fp32 h, so they agree to one bf16 ulp."""
    xg, w, h0, c0 = _case(S, B, H, seed=7 + S)
    xg = np.array(jnp.asarray(xg, jnp.bfloat16).astype(jnp.float32))
    ys_j, cs_j = lstm_scan_fused(jnp.asarray(xg, jnp.bfloat16), *map(jnp.asarray, (w, h0, c0)),
                                 interpret=True)
    ys_t, cs_t = K.lstm_scan_fwd(torch.from_numpy(xg).bfloat16(), *_t(w, h0, c0))
    assert ys_t.dtype == torch.bfloat16 and cs_t.dtype == torch.float32
    np.testing.assert_allclose(ys_t.float().numpy(), np.asarray(ys_j, np.float32),
                               atol=2 ** -8, rtol=2 ** -8)
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), atol=FWD_ATOL, rtol=0)
    # the carry is fp32: rounding h to bf16 every step gives other cells
    xg_t, w_t, h_t, c_t = torch.from_numpy(xg), *_t(w, h0, c0)
    for t in range(S):
        h_t, c_t = tref.lstm_gates_ref(xg_t[t] + h_t @ w_t, c_t)
        h_t = h_t.bfloat16().float()
    assert not torch.equal(c_t, cs_t[-1])


@pytest.mark.parametrize("S,B,H", SHAPES[:3])
def test_plain_backward_matches_pallas_on_the_same_residuals(S, B, H):
    xg, w, h0, c0 = _case(S, B, H, seed=100 + S)
    ys, cs = lstm_scan_fused(*map(jnp.asarray, (xg, w, h0, c0)), interpret=True)
    r = np.random.default_rng(5)
    dys, dhT, dcT = (r.normal(size=s).astype(np.float32) for s in ((S, B, H), (B, H), (B, H)))
    want = lstm_scan_bwd_fused(*map(jnp.asarray, (xg, w, h0, c0, ys, cs, dys, dhT, dcT)),
                               interpret=True)
    got = tref.lstm_scan_bwd_ref(*_t(xg, w, h0, c0, ys, cs, dys, dhT, dcT))
    for name, g, j in zip(("dxg", "dw_hh", "dh0", "dc0"), got, want):
        _close_rel(g.numpy(), j, name)
    # the wrappers' parts give the same: the recurrence, then the dw product
    dxg, dh0, dc0 = K.lstm_scan_bwd_rec(*_t(xg, w, h0, c0, ys, cs, dys, dhT, dcT))
    for name, g, j in zip(("dxg", "dh0", "dc0"), (dxg, dh0, dc0), (got[0], got[2], got[3])):
        assert torch.equal(g, j), name
    _close_rel(K.lstm_scan_dw(*_t(h0, ys), dxg).numpy(), want[1], "dw_hh from the dw part")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_plain_dw_matches_the_jax_backward_at_a_ragged_shape(dtype):
    """dw_hh from the dw part against the Pallas backward's at S·B = 37 and
    H = 100, ragged on every side of the card kernel's tiles (128 x 64 of
    dw, slabs of 8 rows of n) and at its h0/ys seam (n < B reads h0), with
    ys in fp32 and in bf16 as the bf16 forward stores it."""
    S, B, H = 37, 1, 100
    xg, w, h0, c0 = _case(S, B, H, seed=300)
    xg_j = jnp.asarray(xg, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ys, cs = lstm_scan_fused(xg_j, *map(jnp.asarray, (w, h0, c0)), interpret=True)
    assert ys.dtype == xg_j.dtype
    r = np.random.default_rng(6)
    dys, dhT, dcT = (r.normal(size=s).astype(np.float32) for s in ((S, B, H), (B, H), (B, H)))
    want = lstm_scan_bwd_fused(xg_j, *map(jnp.asarray, (w, h0, c0)), ys, cs,
                               *map(jnp.asarray, (dys, dhT, dcT)), interpret=True)
    ys_t = torch.from_numpy(np.array(ys, np.float32)).to(getattr(torch, dtype))
    dw = K.lstm_scan_dw(torch.from_numpy(h0), ys_t, torch.from_numpy(np.array(want[0])))
    assert dw.dtype == torch.float32 and dw.shape == (H, 4 * H)
    _close_rel(dw.numpy(), want[1], f"dw_hh, {dtype} ys")


@pytest.mark.parametrize("S,B,H", SHAPES[:3])
def test_autograd_function_matches_jax_grad(S, B, H):
    xg, w, h0, c0 = _case(S, B, H, seed=200 + S)
    wy = np.random.default_rng(5).normal(size=(S, B, H)).astype(np.float32)

    def f_jax(*args):
        ys, hT, cT = lstm_scan_fused_vjp(*args, interpret=True)
        return (ys * wy).sum() + 1.7 * hT.sum() + 0.9 * cT.sum()

    want = jax.grad(f_jax, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (xg, w, h0, c0)))
    args = [a.requires_grad_() for a in _t(xg, w, h0, c0)]
    ys, hT, cT = K.lstm_scan_fused_vjp(*args)
    ((ys * torch.from_numpy(wy)).sum() + 1.7 * hT.sum() + 0.9 * cT.sum()).backward()
    for name, a, j in zip(("dxg", "dw_hh", "dh0", "dc0"), args, want):
        _close_rel(a.grad.numpy(), j, name)


def test_autograd_function_passes_gradcheck_in_float64():
    r = np.random.default_rng(3)
    S, B, H = 4, 2, 3
    args = [torch.from_numpy(r.normal(size=s) * sc).requires_grad_()
            for s, sc in (((S, B, 4 * H), 0.5), ((H, 4 * H), 0.3), ((B, H), 0.1), ((B, H), 0.1))]
    assert torch.autograd.gradcheck(K.lstm_scan_fused_vjp, args)


def test_wrappers_refuse_other_devices():
    xg, w, h0, c0 = (torch.zeros(s, device="meta") for s in ((3, 2, 32), (8, 32), (2, 8), (2, 8)))
    with pytest.raises(ValueError, match="runs on CUDA or the CPU, not meta"):
        K.lstm_scan_fwd(xg, w, h0, c0)
    with pytest.raises(ValueError, match="w_hh must be"):
        K.lstm_scan_fwd(xg, torch.zeros((8, 16)), h0, c0)


def test_lstm_layer_under_kernel_dispatch_matches_jax_pallas(registries):
    """``tests/test_kernels.py:263-291`` across the packages: B=2, S=16,
    D=12, H=128, the loss and the w_ih, w_hh, b gradients."""
    B, S, D, H = 2, 16, 12, 128
    p = jax.tree.map(np.array, jlstm.lstm_cell_init(jax.random.PRNGKey(0), D, H))
    xs = np.random.default_rng(2).normal(size=(B, S, D)).astype(np.float32)
    _dispatch(registries, "pallas", "kernel")

    def jloss(p, xs):
        ys, (h, c) = jlstm.lstm_layer(p, xs)
        return (ys ** 2).sum() + h.sum() + c.sum()

    l_j, g_j = jax.value_and_grad(jloss)(p, jnp.asarray(xs))
    layer = tlstm.LSTMLayer(D, H)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    ys, (h, c) = layer(torch.from_numpy(xs))
    l_t = (ys ** 2).sum() + h.sum() + c.sum()
    grads = dict(zip(("w_ih", "w_hh", "b"),
                     torch.autograd.grad(l_t, [layer.w_ih, layer.w_hh, layer.b])))
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(g_j[k]), rtol=2e-5, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["auto", "kernel", "ref"])
def test_eligibility_matches_jax_where_the_rules_coincide(registries, mode):
    """With the same weight budget, at lane-tileable H and on the CPU,
    the port's rule decides as JAX's (``repro/models/lstm.py:77-94``)."""
    jreg, treg = registries
    _dispatch(registries, {"kernel": "pallas"}.get(mode, mode), mode)
    jreg.set_override("lstm.scan_max_vmem_mb", 4)
    treg.set_override("lstm.scan_max_smem_mb", 4.0)
    cpu = torch.device("cpu")
    for S in (4, 15, 16, 64):
        for d_h in (128, 256, 512, 640):
            for chunk in (0, 4):
                assert tlstm._scan_kernel_eligible(S, d_h, chunk, cpu) == \
                    jlstm._scan_kernel_eligible(S, d_h, chunk), (S, d_h, chunk)


def test_eligibility_departs_from_jax_on_the_tpu_rules(registries):
    """The lane rule is dropped, the budget admits the paper's H=1152 by
    default, and 'auto' takes the kernel off the CPU."""
    _dispatch(registries, "pallas", "kernel")
    cpu = torch.device("cpu")
    assert tlstm._scan_kernel_eligible(24, 96, 0, cpu)
    assert not jlstm._scan_kernel_eligible(24, 96, 0)
    assert tlstm._scan_kernel_eligible(64, 1152, 0, cpu)
    assert not jlstm._scan_kernel_eligible(64, 1152, 0)
    assert not tlstm._scan_kernel_eligible(64, 1280, 0, cpu)  # 25 MiB: over the budget
    _dispatch(registries, "auto", "auto")
    assert not tlstm._scan_kernel_eligible(64, 1152, 0, cpu)
    assert tlstm._scan_kernel_eligible(64, 1152, 0, torch.device("cuda"))


def _rnnt_configs(**changes):
    tcfg = get_task("asr-rnnt").config
    tcfg = dataclasses.replace(tcfg, specaug=dataclasses.replace(tcfg.specaug, enabled=False),
                               **changes)
    jcfg = jrnnt.RNNTConfig(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                               if f.name != "specaug"}, specaug=JaxSpecAug(enabled=False))
    return tcfg, jcfg


def _rnnt_batch():
    corpus = jax_default_corpus(0)
    idx = (0, 1, 2, 3)
    return {"features": corpus.arena_features[1, idx], "labels": corpus.arena_labels[1, idx],
            "frame_len": corpus.arena_frame_len[1, idx],
            "label_len": corpus.arena_label_len[1, idx]}


def _rnnt_loss_and_grads_match(tcfg, jcfg, atol):
    batch = _rnnt_batch()
    jparams = jax.tree.map(np.asarray, jrnnt.init_params(jcfg, jax.random.PRNGKey(0)))
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jrnnt.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    params = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    loss_t, _ = trnnt.loss_fn(trnnt.RNNT(tcfg), params,
                              {k: torch.from_numpy(v) for k, v in batch.items()})
    grads_t = dict(zip(params, torch.autograd.grad(loss_t, list(params.values()))))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(grads_j))
    for path, g in jax.tree_util.tree_leaves_with_path(params_to_jax(grads_t)):
        np.testing.assert_allclose(g, np.asarray(flat_j[path]), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_rnnt_loss_and_gradients_on_the_scan_kernel_match_jax_pallas(registries):
    """H=128 (the JAX kernel's lane rule), T=24: both packages run the
    encoder, and with scan_min_seq=8 the predictor (U+1=13), through K2:
    the port's plain version, JAX's Pallas kernels in interpret mode."""
    tcfg, jcfg = _rnnt_configs(enc_hidden=128, pred_hidden=128)
    _dispatch(registries, "pallas", "kernel", min_seq=8)
    assert tlstm._scan_kernel_eligible(13, 128, 0, torch.device("cpu"))
    assert jlstm._scan_kernel_eligible(13, 128, 0)
    _rnnt_loss_and_grads_match(tcfg, jcfg, atol=1e-5)


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_time_loop_equals_the_plain_loop_and_jax(chunk):
    """scan_chunk checkpoints the time loop: the same outputs and
    gradients as chunk 0, and as JAX's chunked lax.scan."""
    B, S, D, H = 2, 16, 12, 32
    p = jax.tree.map(np.array, jlstm.lstm_cell_init(jax.random.PRNGKey(1), D, H))
    xs = np.random.default_rng(4).normal(size=(B, S, D)).astype(np.float32)

    def jloss(p, xs):
        ys, (h, c) = jlstm.lstm_layer(p, xs, chunk=chunk)
        return (ys ** 2).sum() + h.sum() + c.sum()

    l_j, g_j = jax.value_and_grad(jloss)(p, jnp.asarray(xs))
    layer = tlstm.LSTMLayer(D, H)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    out = {}
    for c in (0, chunk):
        ys, (h, cT) = layer(torch.from_numpy(xs), chunk=c)
        loss = (ys ** 2).sum() + h.sum() + cT.sum()
        out[c] = (loss, torch.autograd.grad(loss, [layer.w_ih, layer.w_hh, layer.b]))
    assert torch.equal(out[0][0], out[chunk][0])
    for a, b in zip(out[0][1], out[chunk][1]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(out[chunk][0].detach()), float(l_j), rtol=1e-6)
    for k, g in zip(("w_ih", "w_hh", "b"), out[chunk][1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]), rtol=2e-5, atol=2e-5,
                                   err_msg=k)


def test_rnnt_with_scan_chunk_matches_jax():
    """The RNN-T's ``scan_chunk`` (encoder T=24 in chunks of 8; the
    predictor's U+1=13 does not divide and runs one plain loop)."""
    _rnnt_loss_and_grads_match(*_rnnt_configs(scan_chunk=8), atol=1e-5)


def test_backward_phase_timer_runs_on_the_card_only():
    """The timed instantiation is a measurement of the CUDA kernel: on the
    CPU it refuses, and neither it nor the plain backward counts a launch."""
    xg, w, h0, c0 = _t(*_case(5, 3, 8, seed=31))
    ys, cs = tref.lstm_scan_ref(xg, w, h0, c0)
    args = (xg, w, h0, c0, ys, cs, torch.ones_like(ys), torch.ones_like(h0), torch.ones_like(c0))
    launches = K.SCAN_BWD_LAUNCHES
    with pytest.raises(ValueError, match="on the card only"):
        K.lstm_scan_bwd_phases(*args)
    got = K.lstm_scan_bwd_rec(*args)
    want = tref.lstm_scan_bwd_rec_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K.SCAN_BWD_LAUNCHES == launches
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="not meta"):
        K.lstm_scan_bwd_phases(*meta)


def test_forward_phase_timer_runs_on_the_card_only():
    """The forward's timed instantiation is a measurement of the CUDA
    kernel: on the CPU it refuses, and neither it nor the plain forward
    counts a launch."""
    xg, w, h0, c0 = _t(*_case(5, 3, 8, seed=32))
    launches = K.SCAN_FWD_LAUNCHES
    with pytest.raises(ValueError, match="on the card only"):
        K.lstm_scan_fwd_phases(xg, w, h0, c0)
    got = K.lstm_scan_fwd(xg, w, h0, c0)
    want = tref.lstm_scan_ref(xg, w, h0, c0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K.SCAN_FWD_LAUNCHES == launches
    assert len(K.FWD_PHASES) == len(set(K.FWD_PHASES)) and K.FWD_PHASES[0] == "prologue"
    with pytest.raises(ValueError, match="not meta"):
        K.lstm_scan_fwd_phases(*(a.to("meta") for a in (xg, w, h0, c0)))


@pytest.mark.parametrize("S,B,H", SHAPES[:3])
def test_gate_recompute_reproduces_the_pallas_forward(S, B, H):
    """The backward's gate recompute on the saved (ys, cs) of JAX's
    ``lstm_scan_fused`` in interpret mode: its activations give back that
    forward's cells and outputs, and the wrapper on the CPU is the plain
    version, with no launch counted."""
    xg, w, h0, c0 = _case(S, B, H, seed=200 + S)
    ys, cs = (np.asarray(a) for a in lstm_scan_fused(*map(jnp.asarray, (xg, w, h0, c0)),
                                                     interpret=True))
    launches = K.SCAN_BWD_GATES_LAUNCHES
    acts = K.lstm_scan_bwd_gates(*_t(xg, w, h0, ys))
    assert K.SCAN_BWD_GATES_LAUNCHES == launches
    assert acts.shape == (S, B, 4 * H) and acts.dtype == torch.float32
    assert torch.equal(acts, tref.lstm_scan_bwd_gates_ref(*_t(xg, w, h0, ys)))
    i, f, g, o = acts.numpy().reshape(S, B, 4, H).transpose(2, 0, 1, 3)
    c_prev = np.concatenate([c0[None], cs[:-1]])
    np.testing.assert_allclose(f * c_prev + i * g, cs, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(o * np.tanh(cs), ys, atol=FWD_ATOL, rtol=0)


def test_gate_recompute_refuses_what_the_backward_refuses():
    xg, w, h0, _ = _t(*_case(5, 3, 8, seed=41))
    ys = torch.zeros(5, 3, 8)
    with pytest.raises(ValueError, match="sequence tensors"):
        K.lstm_scan_bwd_gates(xg, w, h0, torch.zeros(5, 3, 7))
    with pytest.raises(ValueError, match="several devices"):
        K.lstm_scan_bwd_gates(xg, w, h0, ys.to("meta"))
