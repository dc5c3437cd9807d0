"""The LSTM cell gate kernel (K1): wrappers and autograd.

Replaces the Pallas TPU kernels ``repro/kernels/lstm_gates.py:43
lstm_gates_fused`` and ``:92 lstm_gates_bwd_fused``, joined there by
``lstm_gates_fused_vjp``. The kernels are CUDA C++ in
``csrc/lstm_gates.cu`` (its header states what bounds them on the card).
Their launch path is two PyTorch operators, ``torch.ops.repro_torch.
lstm_gates_fwd`` and ``lstm_gates_bwd`` (``csrc/lstm_gates_op.cpp``):
the validation, the output allocations and the launch in C++ behind one
call, built by ``build.py`` on first use.

A wrapper takes the plain version (``ref.py``) only for a tensor on the
CPU. A CUDA tensor gets the kernel or an exception; nothing falls back.
A call whose tensors are not all on CUDA goes through ``_check``, which
makes every refusal; the operators make the same refusals, with the same
exception types, for tensors on CUDA. ``FWD_LAUNCHES`` and
``BWD_LAUNCHES`` count the kernel launches, so that a run can show that
its LSTM steps went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class _Ops:
    """The launch path's callables, bound on the first launch: the two
    operators, and the handle of a card's current CUDA stream as an int,
    read without building the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream(device).cuda_stream`` builds."""

    fwd = bwd = stream = None

    @classmethod
    def bind(cls) -> None:
        build.load_ops("lstm_gates")
        ops = torch.ops.repro_torch
        cls.fwd, cls.bwd = ops.lstm_gates_fwd.default, ops.lstm_gates_bwd.default
        cls.stream = torch._C._cuda_getCurrentRawStream


def _check(gates: torch.Tensor, c: torch.Tensor, dh=None, dc_next=None) -> bool:
    """Validate shapes and types; True when the kernel must run (CUDA),
    False for the plain version (CPU). Raises on anything else. The
    operators' ``check`` (``csrc/lstm_gates_op.cpp``) makes the same
    refusals in the same order, with the same exception types, for
    tensors on CUDA: keep the two in step. chip_smoke.py's
    ``_k1_refusals`` holds them equal on the card, case by case."""
    if gates.dim() != 2 or gates.shape[1] % 4:
        raise ValueError(f"gates must be (N, 4H), got {tuple(gates.shape)}")
    N, H = gates.shape[0], gates.shape[1] // 4
    tensors = {"c": c, "dh": dh, "dc_next": dc_next}
    for name, t in tensors.items():
        if t is not None and tuple(t.shape) != (N, H):
            raise ValueError(f"{name} must be ({N}, {H}), got {tuple(t.shape)}")
    devices = {t.device for t in (gates, c, dh, dc_next) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"gate tensors lie on several devices: {devices}")
    device = gates.device
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"the LSTM gate kernel runs on CUDA or the CPU, not {device}")
    if gates.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16 gates, got {gates.dtype}")
    if c.dtype != torch.float32 or (dc_next is not None and dc_next.dtype != torch.float32):
        raise TypeError("the kernel keeps the cell state in float32")
    if dh is not None and dh.dtype != gates.dtype:
        raise TypeError(f"dh must have the gate dtype {gates.dtype}, got {dh.dtype}")
    if not all(t.is_contiguous() for t in (gates, c, dh, dc_next) if t is not None):
        raise ValueError("the kernel takes contiguous tensors")
    if N * H >= 2**31 or N * H == 0:
        raise ValueError(f"N*H = {N * H} is outside the kernel's range [1, 2**31)")
    return True


def lstm_gates_fwd(gates: torch.Tensor, c: torch.Tensor):
    """gates (N, 4H) [i|f|g|o], c (N, H) fp32 -> (h_new (N, H) in the
    gate dtype, c_new (N, H) fp32)."""
    global FWD_LAUNCHES
    if not (gates.is_cuda and c.is_cuda):
        _check(gates, c)  # raises unless all are on the CPU
        return ref.lstm_gates_ref(gates, c)
    if _Ops.fwd is None:
        _Ops.bind()
    out = _Ops.fwd(gates, c, _Ops.stream(gates.get_device()))
    FWD_LAUNCHES += 1
    return out


def lstm_gates_bwd(gates, c, dh, dc_next):
    """(gates, c, dh, dc_next) -> (dgates (N, 4H) in the gate dtype,
    dc_prev (N, H) fp32), the activations recomputed from (gates, c)."""
    global BWD_LAUNCHES
    if not (gates.is_cuda and c.is_cuda and dh.is_cuda and dc_next.is_cuda):
        _check(gates, c, dh, dc_next)  # raises unless all are on the CPU
        return ref.lstm_gates_bwd_ref(gates, c, dh, dc_next)
    if _Ops.bwd is None:
        _Ops.bind()
    out = _Ops.bwd(gates, c, dh, dc_next, _Ops.stream(gates.get_device()))
    BWD_LAUNCHES += 1
    return out


class LSTMGatesFn(torch.autograd.Function):
    """The cell with its fused backward: saves only (gates, c) and
    recomputes the activations, as ``_lstm_gates_vjp`` does
    (``repro/kernels/lstm_gates.py:125-148``)."""

    @staticmethod
    def forward(ctx, gates, c):
        ctx.save_for_backward(gates, c)
        return lstm_gates_fwd(gates, c)

    @staticmethod
    def backward(ctx, dh, dc_next):
        gates, c = ctx.saved_tensors
        return lstm_gates_bwd(gates, c, dh.contiguous(), dc_next.contiguous())


def lstm_gates(gates: torch.Tensor, c: torch.Tensor):
    """The entry point of the training and decoding paths: (h_new, c_new),
    differentiable. Where no gradient can flow (grad mode off, as in
    greedy decoding, or neither input requiring one) it is the forward
    alone, without the autograd Function's cost: the same tensors, with
    no ``grad_fn``."""
    if torch.is_grad_enabled() and (gates.requires_grad or c.requires_grad):
        return LSTMGatesFn.apply(gates, c)
    return lstm_gates_fwd(gates, c)
