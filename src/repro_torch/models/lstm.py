"""LSTM stack (the RNN-T encoder and predictor).

The port of ``repro/models/lstm.py:35-155`` on the reference's per-step
path: the input matmul ``xs @ w_ih + b`` is hoisted out of the time
loop, each step adds ``h @ w_hh`` with ``torch.matmul`` (the JAX package
leaves this GEMM to XLA), and the gate nonlinearities run in the K1
kernel (``repro_torch.kernels.lstm_gates``). The dtype contract is
``lstm_gates``'s: gates and h in the compute dtype, c always fp32. The
full-scan kernel (K2) is not ported yet.

``lstm_cell_step``, ``lstm_stack_step`` and ``lstm_stack_init_state``
(``repro/models/lstm.py:71-74, 158-171``) are the single-step decode
path; the cell goes through K1's forward there too.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.lstm_gates import lstm_gates


class _RecurrentMatmul(torch.autograd.Function):
    """``h @ w_c`` where ``w_c`` is ``w`` cast to the compute dtype once
    per layer. Its backward hands ``w`` each step's product in fp32, so
    the weight gradient accumulates over the steps in fp32, as the
    reference's scan does with its per-step cast, without a per-step
    copy of the weight."""

    @staticmethod
    def forward(ctx, h, w, w_c):
        ctx.save_for_backward(h, w_c)
        ctx.w_dtype = w.dtype
        return h @ w_c

    @staticmethod
    def backward(ctx, grad):
        h, w_c = ctx.saved_tensors
        return grad @ w_c.T, (h.T @ grad).to(ctx.w_dtype), None


def lstm_layer(w_ih, w_hh, b, xs, h0=None, c0=None):
    """xs (B, S, d_in) -> (ys (B, S, H), (h, c) final). The compute dtype
    is xs's; the cell state c is fp32."""
    B, S, _ = xs.shape
    H = w_hh.shape[0]
    h = xs.new_zeros((B, H)) if h0 is None else h0
    c = torch.zeros((B, H), dtype=torch.float32, device=xs.device) if c0 is None else c0
    xg = xs @ w_ih.to(xs.dtype) + b.to(xs.dtype)  # (B, S, 4H), one large GEMM
    w_hh_c = w_hh.to(xs.dtype)
    ys = []
    for t in range(S):
        gates = xg[:, t] + _RecurrentMatmul.apply(h, w_hh, w_hh_c)
        h, c = lstm_gates(gates, c)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


class LSTMLayer(nn.Module):
    """One layer's parameters under the JAX names and layout: w_ih
    (d_in, 4H), w_hh (H, 4H), b (4H,), gate order [i|f|g|o]."""

    def __init__(self, d_in: int, d_hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty((d_in, 4 * d_hidden), dtype=dtype))
        self.w_hh = nn.Parameter(torch.empty((d_hidden, 4 * d_hidden), dtype=dtype))
        self.b = nn.Parameter(torch.empty((4 * d_hidden,), dtype=dtype))

    def forward(self, xs, h0=None, c0=None):
        return lstm_layer(self.w_ih, self.w_hh, self.b, xs, h0, c0)


def lstm_stack(layers, xs):
    """Layer-by-layer forward. Returns ((B, S, H), [(h, c)] per layer)."""
    states = []
    for layer in layers:
        xs, st = layer(xs)
        states.append(st)
    return xs, states


def lstm_cell_step(w_ih, w_hh, b, x, h, c):
    """x (B, d_in); h (B, H) in x's dtype, c (B, H) fp32 -> (h, c). The
    weights are cast to x's dtype (a no-op for weights already cast)."""
    gates = x @ w_ih.to(x.dtype) + h @ w_hh.to(x.dtype) + b.to(x.dtype)
    return lstm_gates(gates, c)


def lstm_stack_step(weights, x, states):
    """One step of the stack (decode). weights: [(w_ih, w_hh, b)] per
    layer; states: [(h, c)] per layer. Returns (top h, new states)."""
    new_states = []
    for (w_ih, w_hh, b), (h, c) in zip(weights, states):
        x, c = lstm_cell_step(w_ih, w_hh, b, x, h, c)
        new_states.append((x, c))
    return x, new_states


def lstm_stack_init_state(layers, batch: int, dtype: torch.dtype, device):
    """Zero (h, c) per layer: h in ``dtype``, c fp32."""
    return [(torch.zeros((batch, layer.w_hh.shape[0]), dtype=dtype, device=device),
             torch.zeros((batch, layer.w_hh.shape[0]), dtype=torch.float32, device=device))
            for layer in layers]
