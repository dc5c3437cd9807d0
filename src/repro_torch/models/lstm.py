"""LSTM stack (the RNN-T encoder and predictor).

The port of ``repro/models/lstm.py:35-155``. The input product
``xs @ w_ih + b`` is hoisted out of the recurrence (one large GEMM, left
to ``torch.matmul`` as the JAX package leaves it to XLA). The recurrence
then takes one of two paths, chosen as ``repro/models/lstm.py:77-138``
chooses, from the tuning registry's ``lstm.scan_*`` knobs
(``repro_torch.profile.tuner``):

- the scan kernel (K2, ``repro_torch.kernels.lstm_scan``): the whole
  sequence in one launch, h carried in fp32, w_hh fp32, and a fused
  backward;
- the time loop: each step adds ``h @ w_hh`` (``torch.matmul``, w_hh cast
  to the compute dtype once per layer) and runs the cell in K1
  (``repro_torch.kernels.lstm_gates``), h rounded to the compute dtype
  every step; ``chunk`` checkpoints it in time chunks.

``_scan_kernel_eligible`` keeps JAX's rule but for two facts of the TPU:
the lane rule ``d_h % 128 == 0`` is dropped (the kernel masks ragged H,
as K1 does), and the weight budget is ``lstm.scan_max_smem_mb``, the
shared memory the H100 kernel holds w_hh in (21 MiB by default, which
admits the paper's H=1152), in place of JAX's 8 MB of TPU VMEM. The
dtype contract is ``lstm_gates``'s: h in the compute dtype, c fp32.

``lstm_cell_step``, ``lstm_stack_step`` and ``lstm_stack_init_state``
(``repro/models/lstm.py:71-74, 158-171``) are the single-step decode
path; the cell goes through K1's forward there.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.lstm_gates import lstm_gates
from repro_torch.kernels.lstm_scan import lstm_scan_fused_vjp
from repro_torch.models.layers import chunked_scan
from repro_torch.profile.tuner import get_knob


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


def _scan_kernel_eligible(S: int, d_h: int, chunk: int, device: torch.device) -> bool:
    """Whether the layer runs the scan kernel: not under 'ref' or a time
    chunk (the kernel does not checkpoint), a sequence of at least
    ``lstm.scan_min_seq`` steps, an fp32 w_hh within
    ``lstm.scan_max_smem_mb``, and, under 'auto', tensors off the CPU."""
    mode = get_knob("lstm.scan_dispatch")
    if mode == "ref" or chunk:
        return False
    whh_mb = d_h * 4 * d_h * 4 / 2**20
    if S < get_knob("lstm.scan_min_seq") or whh_mb > get_knob("lstm.scan_max_smem_mb"):
        return False
    return mode == "kernel" or device.type != "cpu"


def lstm_layer(w_ih, w_hh, b, xs, h0=None, c0=None, chunk: int = 0):
    """xs (B, S, d_in) -> (ys (B, S, H), (h, c) final). The compute dtype
    is xs's; the cell state c is fp32."""
    B, S, _ = xs.shape
    H = w_hh.shape[0]
    c = torch.zeros((B, H), dtype=torch.float32, device=xs.device) if c0 is None else c0
    if _scan_kernel_eligible(S, H, chunk, xs.device):
        # time-major, as the kernel takes it; xs is often a transposed view
        # of the layer below's time-major ys, and then needs no copy
        xg = xs.transpose(0, 1) @ w_ih.to(xs.dtype) + b.to(xs.dtype)    # (S, B, 4H)
        h = c.new_zeros((B, H)) if h0 is None else h0.float()
        ys, hT, cT = lstm_scan_fused_vjp(xg.contiguous(), w_hh.float(), h, c.float())
        return ys.transpose(0, 1), (hT.to(xs.dtype), cT)
    h = xs.new_zeros((B, H)) if h0 is None else h0
    xg = xs @ w_ih.to(xs.dtype) + b.to(xs.dtype)  # (B, S, 4H), one large GEMM
    w_hh_c = w_hh.to(xs.dtype)

    def step(carry, xg_t):
        h, c = carry
        h, c = lstm_gates(xg_t + _RecurrentMatmul.apply(h, w_hh, w_hh_c), c)
        return (h, c), h

    (h, c), ys = chunked_scan(step, (h, c), xg.transpose(0, 1), chunk)
    return ys.transpose(0, 1), (h, c)


class LSTMLayer(nn.Module):
    """One layer's parameters under the JAX names and layout: w_ih
    (d_in, 4H), w_hh (H, 4H), b (4H,), gate order [i|f|g|o]."""

    def __init__(self, d_in: int, d_hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty((d_in, 4 * d_hidden), dtype=dtype))
        self.w_hh = nn.Parameter(torch.empty((d_hidden, 4 * d_hidden), dtype=dtype))
        self.b = nn.Parameter(torch.empty((4 * d_hidden,), dtype=dtype))

    def forward(self, xs, h0=None, c0=None, chunk: int = 0):
        return lstm_layer(self.w_ih, self.w_hh, self.b, xs, h0, c0, chunk)


def lstm_stack(layers, xs, chunk: int = 0):
    """Layer-by-layer forward. Returns ((B, S, H), [(h, c)] per layer)."""
    states = []
    for layer in layers:
        xs, st = layer(xs, chunk=chunk)
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
