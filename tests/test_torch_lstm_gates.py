"""K1 (LSTM cell gates): the port's plain version and autograd Function
against the JAX package's oracle and its Pallas kernel in interpret mode.

On the CPU the port's wrapper takes the plain version, so these tests
hold the arithmetic the CUDA kernel must reproduce; ``chip_smoke.py``
holds the kernel itself against the plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.lstm_gates import lstm_gates_bwd_fused, lstm_gates_fused
from repro.models.lstm import lstm_gates as jax_model_lstm_gates
from repro_torch.kernels import lstm_gates as K
from repro_torch.kernels import ref as tref

ATOL = 1e-6  # fp32: the same formula on the same inputs, a few ulps apart


def _inputs(B, H, seed, extra=False):
    r = np.random.default_rng(seed)
    arrays = [r.normal(size=(B, 4 * H)).astype(np.float32) * 2,
              r.normal(size=(B, H)).astype(np.float32)]
    if extra:
        arrays += [r.normal(size=(B, H)).astype(np.float32),
                   r.normal(size=(B, H)).astype(np.float32)]
    return arrays


@pytest.mark.parametrize("B,H,th", [(3, 128, 128), (2, 256, 128)])
def test_plain_forward_matches_jax_ref_and_pallas(B, H, th):
    g, c = _inputs(B, H, seed=B * H)
    h_t, c_t = K.lstm_gates_fwd(torch.from_numpy(g), torch.from_numpy(c))
    for h_j, c_j in (jref.lstm_gates_ref(jnp.asarray(g), jnp.asarray(c)),
                     lstm_gates_fused(jnp.asarray(g), jnp.asarray(c), th=th, interpret=True)):
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, rtol=0)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,H,th", [(3, 128, 128), (2, 256, 128)])
def test_plain_backward_matches_pallas_and_autograd(B, H, th):
    g, c, dh, dcn = _inputs(B, H, seed=7 + B * H, extra=True)
    dg_t, dc_t = K.lstm_gates_bwd(*map(torch.from_numpy, (g, c, dh, dcn)))
    dg_j, dc_j = lstm_gates_bwd_fused(*map(jnp.asarray, (g, c, dh, dcn)), th=th,
                                      interpret=True)
    np.testing.assert_allclose(dg_t.numpy(), np.asarray(dg_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dc_t.numpy(), np.asarray(dc_j), atol=ATOL, rtol=0)

    gt, ct = (torch.from_numpy(a).requires_grad_() for a in (g, c))
    h, c_new = tref.lstm_gates_ref(gt, ct)
    dg_a, dc_a = torch.autograd.grad((h, c_new), (gt, ct),
                                     (torch.from_numpy(dh), torch.from_numpy(dcn)))
    np.testing.assert_allclose(dg_t.numpy(), dg_a.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dc_t.numpy(), dc_a.numpy(), atol=ATOL, rtol=0)


def test_autograd_function_gradcheck_float64():
    r = np.random.default_rng(3)
    g = torch.from_numpy(r.normal(size=(3, 4 * 5))).requires_grad_()
    c = torch.from_numpy(r.normal(size=(3, 5))).requires_grad_()
    assert torch.autograd.gradcheck(K.LSTMGatesFn.apply, (g, c), eps=1e-6, atol=1e-7)


def test_ragged_hidden_matches_jax_model_gates():
    """H = 96 (the tiny task's width) is not a multiple of 128: the TPU
    gate refuses it, the port takes any H."""
    g, c = _inputs(4, 96, seed=11)
    h_t, c_t = K.lstm_gates(torch.from_numpy(g), torch.from_numpy(c))
    h_j, c_j = jax_model_lstm_gates(jnp.asarray(g), jnp.asarray(c))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL, rtol=0)


def test_bf16_gates_keep_the_jax_dtype_contract():
    """bf16 gates, fp32 c: h comes back bf16, c fp32, in both packages.
    Both round the same fp32 inputs to bf16 (nearest even); the outputs
    agree to one bf16 ulp at |h| <= 1 (atol 1e-2) and c to fp32 (1e-5)."""
    g, c = _inputs(4, 64, seed=5)
    h_t, c_t = K.lstm_gates(torch.from_numpy(g).to(torch.bfloat16), torch.from_numpy(c))
    h_j, c_j = jref.lstm_gates_ref(jnp.asarray(g, jnp.bfloat16), jnp.asarray(c))
    assert h_t.dtype == torch.bfloat16 and h_j.dtype == jnp.bfloat16
    assert c_t.dtype == torch.float32 and c_j.dtype == jnp.float32
    np.testing.assert_allclose(h_t.float().numpy(), np.asarray(h_j, np.float32), atol=1e-2,
                               rtol=0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5, rtol=0)


def test_wrapper_refuses_bad_shapes_and_devices():
    g = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        K.lstm_gates_fwd(torch.zeros(2, 7), torch.zeros(2, 2))
    with pytest.raises(ValueError):
        K.lstm_gates_fwd(g, torch.zeros(2, 3))
    with pytest.raises(ValueError):
        K.lstm_gates_fwd(g.to("meta"), torch.zeros(2, 2, device="meta"))
    launches = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    K.lstm_gates_fwd(g, torch.zeros(2, 2))
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == launches  # the plain version is no launch


# Inputs for the refusals, each with the exception type ``_check`` raises
# on them (None: the CPU's plain version runs, as before): (gates, c) for
# the forward, (gates, c, dh, dc_next) for the backward.
def _refusal_cases():
    g, c = torch.zeros(2, 8), torch.zeros(2, 2)
    meta = torch.zeros(2, 2, device="meta")
    return {
        "gates (2, 7)": ((torch.zeros(2, 7), c), ValueError),
        "gates 1-d": ((torch.zeros(8), c), ValueError),
        "c (2, 3)": ((g, torch.zeros(2, 3)), ValueError),
        "c on meta": ((g, meta), ValueError),
        "all on meta": ((g.to("meta"), meta), ValueError),
        "float16 gates on the CPU": ((g.half(), c), None),
        "non-contiguous gates on the CPU": ((torch.zeros(8, 2).t(), c), None),
        "dh (3, 2)": ((g, c, torch.zeros(3, 2), c), ValueError),
        "dc_next on meta": ((g, c, c, meta), ValueError),
        "bf16 dh on the CPU": ((g, c, c.bfloat16(), c), None),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_wrappers_refuse_what_check_refuses(case):
    """The launch path sends every call that is not all on CUDA through
    ``_check``: the same inputs raise the same exception type as before,
    and what ``_check`` passes on the CPU runs the plain version (the
    operators make the CUDA refusals; chip_smoke.py holds them to
    ``_check`` on the card)."""
    args, want = _refusal_cases()[case]
    wrapper = K.lstm_gates_fwd if len(args) == 2 else K.lstm_gates_bwd
    launches = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    if want is None:
        assert K._check(*args) is False
        plain = tref.lstm_gates_ref if len(args) == 2 else tref.lstm_gates_bwd_ref
        for got, ref_out in zip(wrapper(*args), plain(*args)):
            assert torch.equal(got, ref_out)
    else:
        with pytest.raises(want):
            K._check(*args)
        with pytest.raises(want):
            wrapper(*args)
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == launches


@pytest.mark.parametrize("requires_grad", [True, False])
def test_lstm_gates_without_grad_is_the_forward_alone(requires_grad):
    """Under no_grad (the evaluation's decode), or with no input that
    requires grad, ``lstm_gates`` skips the autograd Function: the same
    values as with grad on, and no ``grad_fn``."""
    g, c = (torch.from_numpy(a) for a in _inputs(3, 128, seed=21))
    with_grad = K.lstm_gates(g.clone().requires_grad_(), c.clone().requires_grad_())
    assert all(t.grad_fn is not None for t in with_grad)
    gi, ci = g.clone().requires_grad_(requires_grad), c.clone().requires_grad_(requires_grad)
    with torch.no_grad():
        no_grad = K.lstm_gates(gi, ci)
    plain_inputs = K.lstm_gates(g, c)  # grad mode on, nothing requires grad
    for out in (no_grad, plain_inputs):
        assert all(t.grad_fn is None and not t.requires_grad for t in out)
        for a, b in zip(out, with_grad):
            assert torch.equal(a, b.detach())


def test_lstm_cell_step_under_no_grad_matches_pallas():
    """The decode's cell step as the evaluation runs it (no_grad, the
    forward alone) against JAX's ``lstm_gates_fused`` in interpret mode on
    the same pre-activations, at a narrow width."""
    from repro_torch.models.lstm import lstm_cell_step

    r = np.random.default_rng(9)
    B, D, H = 3, 16, 128
    w_ih, w_hh = (r.normal(size=s).astype(np.float32) * 0.2 for s in ((D, 4 * H), (H, 4 * H)))
    b, x = r.normal(size=4 * H).astype(np.float32) * 0.1, r.normal(size=(B, D)).astype(np.float32)
    h, c = (r.normal(size=(B, H)).astype(np.float32) * 0.5 for _ in range(2))
    with torch.no_grad():
        h_t, c_t = lstm_cell_step(*map(torch.from_numpy, (w_ih, w_hh, b, x, h, c)))
    assert h_t.grad_fn is None and c_t.grad_fn is None
    gates = torch.from_numpy(x) @ torch.from_numpy(w_ih) + torch.from_numpy(h) @ \
        torch.from_numpy(w_hh) + torch.from_numpy(b)
    h_j, c_j = lstm_gates_fused(jnp.asarray(gates.numpy()), jnp.asarray(c), th=128,
                                interpret=True)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL, rtol=0)


def test_lstm_gates_entry_point_gradcheck_float64():
    """Through ``lstm_gates`` itself with grad on: the autograd Function."""
    r = np.random.default_rng(4)
    g = torch.from_numpy(r.normal(size=(2, 4 * 6))).requires_grad_()
    c = torch.from_numpy(r.normal(size=(2, 6))).requires_grad_()
    assert torch.autograd.gradcheck(K.lstm_gates, (g, c), eps=1e-6, atol=1e-7)


def test_operator_library_is_bound_to_the_torch_it_was_built_against(monkeypatch):
    """The operator library is compiled against torch's headers and C++
    ABI: another torch version names another library, so a stale build
    never loads; a plain C library's name depends on its source alone."""
    from repro_torch.kernels import build

    before = build.library_path("lstm_gates"), build.library_path("lstm_scan")
    monkeypatch.setattr(torch, "__version__", torch.__version__ + ".other")
    after = build.library_path("lstm_gates"), build.library_path("lstm_scan")
    assert after[0] != before[0] and after[1] == before[1]


def test_library_names_hash_the_shared_headers(monkeypatch, tmp_path):
    """The sources include csrc/tile_product.cuh: an edited header names
    another library for every source, so a stale build never loads."""
    from repro_torch.kernels import build

    assert build.CSRC / "tile_product.cuh" in build._headers()
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "_headers", lambda: [header])
    before = {name: build.library_path(name) for name in build.SOURCES}
    header.write_text("// two\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(after[name] != before[name] for name in build.SOURCES)
