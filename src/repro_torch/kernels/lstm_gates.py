"""The LSTM cell gate kernel (K1): wrappers and autograd.

Replaces the Pallas TPU kernels ``repro/kernels/lstm_gates.py:43
lstm_gates_fused`` and ``:92 lstm_gates_bwd_fused``, joined there by
``lstm_gates_fused_vjp``. The kernels are CUDA C++ in
``csrc/lstm_gates.cu`` (its header states what bounds them on the card),
built by ``build.py`` and called through ctypes.

A wrapper takes the plain version (``ref.py``) only for a tensor on the
CPU. A CUDA tensor gets the kernel or an exception; nothing falls back.
``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the kernel launches, so that
a run can show that its LSTM steps went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("lstm_gates")
    lib.lstm_gates_fwd.argtypes = [_I, _P, _P, _P, _P, _I, _I, _P]
    lib.lstm_gates_fwd.restype = _I
    lib.lstm_gates_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _P]
    lib.lstm_gates_bwd.restype = _I
    return lib


def _check(gates: torch.Tensor, c: torch.Tensor, dh=None, dc_next=None) -> bool:
    """Validate shapes and types; True when the kernel must run (CUDA),
    False for the plain version (CPU). Raises on anything else."""
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
    if not _check(gates, c):
        return ref.lstm_gates_ref(gates, c)
    N, H = c.shape
    h = torch.empty((N, H), dtype=gates.dtype, device=gates.device)
    c_new = torch.empty_like(c)
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    build.check_launch(
        _lib().lstm_gates_fwd(_DTYPE_CODES[gates.dtype], gates.data_ptr(), c.data_ptr(),
                              h.data_ptr(), c_new.data_ptr(), N, H, stream),
        "lstm_gates_fwd",
    )
    FWD_LAUNCHES += 1
    return h, c_new


def lstm_gates_bwd(gates, c, dh, dc_next):
    """(gates, c, dh, dc_next) -> (dgates (N, 4H) in the gate dtype,
    dc_prev (N, H) fp32), the activations recomputed from (gates, c)."""
    global BWD_LAUNCHES
    if not _check(gates, c, dh, dc_next):
        return ref.lstm_gates_bwd_ref(gates, c, dh, dc_next)
    N, H = c.shape
    dgates = torch.empty_like(gates)
    dc_prev = torch.empty_like(c)
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    build.check_launch(
        _lib().lstm_gates_bwd(_DTYPE_CODES[gates.dtype], gates.data_ptr(), c.data_ptr(),
                              dh.data_ptr(), dc_next.data_ptr(), dgates.data_ptr(),
                              dc_prev.data_ptr(), N, H, stream),
        "lstm_gates_bwd",
    )
    BWD_LAUNCHES += 1
    return dgates, dc_prev


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
    """The training-path entry point: (h_new, c_new), differentiable."""
    return LSTMGatesFn.apply(gates, c)
