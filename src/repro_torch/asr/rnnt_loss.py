"""RNN-T (transducer) loss, Graves 2012, in torch ops.

The port of ``repro/asr/rnnt_loss.py:28-86``. The forward DP over the
(T, U+1) lattice:

    alpha[0,0] = 0
    alpha[t,u] = logaddexp(alpha[t-1,u] + blank[t-1,u],
                           alpha[t,u-1] + label[t,u-1])
    loss       = -(alpha[T-1,U] + blank[T-1,U])

The reference solves each row (fixed t) as a log-semiring linear
recurrence over u. Here each column (fixed u) is solved instead, as a
recurrence over t, in closed form:

    alpha[t,u] = D[t] + logcumsumexp_j<=t(A[j] - D[j])

with A[j] = alpha[j,u-1] + label[j,u-1] and D the exclusive cumulative
sum of blank[:, u] over t. The blank log-probs are never masked, so D
stays finite, and the loop runs U+1 times with batched tensor ops and
plain autograd. There is no Pallas kernel for this DP.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30


def rnnt_alpha(blank_lp: torch.Tensor, label_lp: torch.Tensor) -> torch.Tensor:
    """Forward variables. blank_lp, label_lp (B, T, U1); label_lp must be
    masked to NEG_INF where no label is emitted. Returns alpha (B, T, U1)."""
    B, T, U1 = blank_lp.shape
    zeros = blank_lp.new_zeros((B, 1, U1))
    D = torch.cat([zeros, blank_lp[:, :-1].cumsum(dim=1)], dim=1)
    A = torch.full((B, T), NEG_INF, dtype=blank_lp.dtype, device=blank_lp.device)
    A[:, 0] = 0.0
    cols = []
    for u in range(U1):
        Du = D[:, :, u]
        col = Du + torch.logcumsumexp(A - Du, dim=1)
        cols.append(col)
        A = col + label_lp[:, :, u]
    return torch.stack(cols, dim=-1)


def rnnt_loss_from_logprobs(blank_lp, label_lp, frame_len, label_len) -> torch.Tensor:
    """Batched negative log-likelihood (B,).

    blank_lp, label_lp (B, T, U1); frame_len (B,) in [1, T]; label_len
    (B,) in [0, U1-1]. Positions u >= label_len emit no label."""
    B, T, U1 = blank_lp.shape
    label_len = label_len.long()
    u_idx = torch.arange(U1, device=blank_lp.device)
    label_lp = label_lp.masked_fill(u_idx[None, None, :] >= label_len[:, None, None], NEG_INF)
    alphas = rnnt_alpha(blank_lp, label_lp)
    t_last = (frame_len.long() - 1).clamp(0, T - 1)
    b_idx = torch.arange(B, device=blank_lp.device)
    return -(alphas[b_idx, t_last, label_len] + blank_lp[b_idx, t_last, label_len])
