"""The port's transducer DP against ``repro.asr.rnnt_loss`` on random
log-probs, including the edge lengths frame_len in {1, T} and
label_len in {0, U}."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.asr.rnnt_loss import rnnt_loss_from_logprobs as jax_loss
from repro_torch.asr.rnnt_loss import rnnt_loss_from_logprobs

RTOL = 1e-5          # the loss: fp32 sums of O(T + U) log-probs in another order
GRAD_ATOL = 1e-5     # gradients are probabilities in [0, 1]


def _logprobs(B, T, U1, V, seed):
    r = np.random.default_rng(seed)
    lp = np.asarray(jax.nn.log_softmax(r.normal(size=(B, T, U1, V)).astype(np.float32) * 2))
    labels = r.integers(1, V, size=(B, U1))
    blank = lp[..., 0]
    label = np.take_along_axis(lp, labels[:, None, :, None], axis=-1)[..., 0]
    return blank.astype(np.float32), label.astype(np.float32)


CASES = [
    # (T, U, frame_len, label_len)
    (6, 4, [6, 1, 4], [4, 0, 2]),
    (9, 5, [1, 9, 9], [5, 5, 0]),
    (1, 3, [1, 1, 1], [0, 3, 1]),
    (12, 8, [12, 7, 3], [8, 1, 3]),
]


@pytest.mark.parametrize("T,U,frame_len,label_len", CASES)
def test_loss_and_gradient_match_jax(T, U, frame_len, label_len):
    B = len(frame_len)
    blank, label = _logprobs(B, T, U + 1, 7, seed=T * 31 + U)
    fl, ll = np.asarray(frame_len, np.int32), np.asarray(label_len, np.int32)
    w = np.random.default_rng(1).uniform(0.5, 1.5, size=B).astype(np.float32)

    def jloss(b, lab):
        return jnp.sum(jax_loss(b, lab, jnp.asarray(fl), jnp.asarray(ll)) * w)

    nll_j = jax_loss(jnp.asarray(blank), jnp.asarray(label), jnp.asarray(fl), jnp.asarray(ll))
    gb_j, gl_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(blank), jnp.asarray(label))

    bt, lt = (torch.from_numpy(a).requires_grad_() for a in (blank, label))
    nll_t = rnnt_loss_from_logprobs(bt, lt, torch.from_numpy(fl), torch.from_numpy(ll))
    np.testing.assert_allclose(nll_t.detach().numpy(), np.asarray(nll_j), rtol=RTOL)
    (nll_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_j), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gl_j), atol=GRAD_ATOL, rtol=0)
    assert torch.isfinite(bt.grad).all() and torch.isfinite(lt.grad).all()


def test_single_path_lattice_is_the_path_sum():
    """T = 1, U = 2: one path (two labels, then the final blank)."""
    blank, label = _logprobs(1, 1, 3, 5, seed=4)
    nll = rnnt_loss_from_logprobs(torch.from_numpy(blank), torch.from_numpy(label),
                                  torch.tensor([1]), torch.tensor([2]))
    want = -(label[0, 0, 0] + label[0, 0, 1] + blank[0, 0, 2])
    np.testing.assert_allclose(nll.numpy(), [want], rtol=1e-6)
