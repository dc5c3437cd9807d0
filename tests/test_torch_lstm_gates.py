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
