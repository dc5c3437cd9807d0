"""The port's LSTM layer and stack against the JAX package's, with the
JAX weights carried across (S=7, B=3, H=96, two layers, fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lstm import LSTMConfig, lstm_layer, lstm_stack, lstm_stack_init
from repro_torch.convert import params_from_jax
from repro_torch.models import lstm as tlstm

RTOL, ATOL = 1e-5, 1e-6  # fp32; sums over H=96 taken in another order

S, B, D_IN, H = 7, 3, 16, 96


def _setup(seed=0):
    params = jax.tree.map(np.asarray, lstm_stack_init(
        jax.random.PRNGKey(seed), LSTMConfig(D_IN, H, 2)))
    xs = np.random.default_rng(seed).normal(size=(B, S, D_IN)).astype(np.float32)
    layers = torch.nn.ModuleList(tlstm.LSTMLayer(D_IN if i == 0 else H, H) for i in range(2))
    layers.load_state_dict(params_from_jax(params))
    return params, xs, layers


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_lstm_layer_matches_jax():
    params, xs, layers = _setup()
    ys_j, (h_j, c_j) = lstm_layer(params[0], jnp.asarray(xs))
    ys_t, (h_t, c_t) = layers[0](torch.from_numpy(xs))
    _close(ys_t, ys_j)
    _close(h_t, h_j)
    _close(c_t, c_j)
    assert c_t.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_lstm_stack_outputs_and_final_states_match_jax(seed):
    params, xs, layers = _setup(seed)
    ys_j, states_j = lstm_stack(params, jnp.asarray(xs))
    ys_t, states_t = tlstm.lstm_stack(layers, torch.from_numpy(xs))
    _close(ys_t, ys_j)
    for (h_t, c_t), (h_j, c_j) in zip(states_t, states_j):
        _close(h_t, h_j)
        _close(c_t, c_j)


def test_lstm_stack_gradients_match_jax():
    """The recurrent matmul's custom backward and the gate backward
    together give the JAX scan's gradients."""
    params, xs, layers = _setup(2)
    cot = np.random.default_rng(9).normal(size=(B, S, H)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(lstm_stack(p, x)[0] * cot)

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(xs))
    x_t = torch.from_numpy(xs).requires_grad_()
    (tlstm.lstm_stack(layers, x_t)[0] * torch.from_numpy(cot)).sum().backward()
    _close(x_t.grad, gx_j)
    for name, p in layers.named_parameters():
        i, leaf = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp_j[int(i)][leaf]),
                                   rtol=1e-4, atol=1e-5)
