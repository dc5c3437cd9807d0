"""The fused RNN-T joint kernels (K3 forward, K4 backward): wrappers and
autograd.

Replaces the Pallas TPU kernels ``repro/kernels/rnnt_joint.py:86
rnnt_joint_fused`` and ``:251 rnnt_joint_bwd_fused``, joined there by the
custom VJP of ``repro/kernels/ops.py:78-123``. The kernels are CUDA C++
in ``csrc/rnnt_joint.cu`` (its header states what bounds them on the
card), built by ``build.py`` and called through ctypes.

A wrapper takes the plain version (``ref.py``) only for tensors on the
CPU. CUDA tensors get the kernels or an exception; nothing falls back.
Each kernel has a launch counter, raised where it launches:
``FWD_LAUNCHES`` (K3), and ``BWD_EG_LAUNCHES``, ``BWD_REDUCE_LAUNCHES``
and ``BWD_W_LAUNCHES`` (the three kernels of K4), so that a run can show
that its joint went through every one of them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

FWD_LAUNCHES = 0
BWD_EG_LAUNCHES = 0
BWD_REDUCE_LAUNCHES = 0
BWD_W_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_KERNELS = {"rnnt_joint_fwd": 0, "rnnt_joint_bwd_eg": 1, "rnnt_joint_bwd_w": 2}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("rnnt_joint")
    lib.rnnt_joint_smem_bytes.argtypes = [_I, _I]
    lib.rnnt_joint_smem_bytes.restype = ctypes.c_longlong
    lib.rnnt_joint_fwd.argtypes = [_I] + [_P] * 8 + [_I] * 5 + [_P]
    lib.rnnt_joint_bwd_eg.argtypes = [_I] + [_P] * 9 + [_I] * 5 + [_P]
    lib.rnnt_joint_bwd_reduce.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    lib.rnnt_joint_bwd_w.argtypes = [_I] + [_P] * 10 + [_I] * 5 + [_P]
    for fn in (lib.rnnt_joint_fwd, lib.rnnt_joint_bwd_eg, lib.rnnt_joint_bwd_reduce,
               lib.rnnt_joint_bwd_w):
        fn.restype = _I
    return lib


@functools.cache
def _smem_refusal(device_index: int, J: int) -> str | None:
    """Why the kernels cannot run at joint width J on this card, or None
    when their shared memory fits it."""
    limit = torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin
    for name, kernel in _SMEM_KERNELS.items():
        need = _lib().rnnt_joint_smem_bytes(kernel, J)
        if need > limit:
            return f"{name} needs {need} B of shared memory at J={J}; the card gives a " \
                   f"block {limit} B"
    return None


def _check(e, g, w, b, labels, lse=None, dblank=None, dlabel=None) -> bool:
    """Validate shapes and types; True when the kernels must run (CUDA),
    False for the plain version (CPU). Raises on anything else."""
    if e.dim() != 3 or g.dim() != 3 or w.dim() != 2 or b.dim() != 1 or labels.dim() != 2:
        raise ValueError("the joint takes e (B, T, J), g (B, U1, J), w (J, V), b (V,) and "
                         "labels (B, U1)")
    B, T, J = e.shape
    U1, V = g.shape[1], w.shape[1]
    shapes = {"g": (g, (B, U1, J)), "w": (w, (J, V)), "b": (b, (V,)),
              "labels": (labels, (B, U1)), "lse": (lse, (B, T, U1)),
              "dblank": (dblank, (B, T, U1)), "dlabel": (dlabel, (B, T, U1))}
    for name, (t, want) in shapes.items():
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    if labels.is_floating_point() or labels.is_complex():
        raise TypeError(f"labels must be integer ids, got {labels.dtype}")
    if g.dtype != e.dtype:
        raise TypeError(f"e and g must share a dtype, got {e.dtype} and {g.dtype}")
    tensors = [t for t in (e, g, w, b, labels, lse, dblank, dlabel) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"joint tensors lie on several devices: {devices}")
    device = e.device
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"the joint kernels run on CUDA or the CPU, not {device}")
    if e.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16 e and g, got {e.dtype}")
    if any(t.dtype != torch.float32 for t in (w, b, lse, dblank, dlabel) if t is not None):
        raise TypeError("the kernels take w, b, lse and the cotangents in float32")
    if labels.dtype != torch.int32:
        raise TypeError(f"the kernels take int32 labels, got {labels.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernels take contiguous tensors")
    if min(B, T, U1, J, V) == 0 or B * T * U1 * J >= 2**31 or J * V >= 2**31:
        raise ValueError(f"shape (B, T, U1, J, V) = {(B, T, U1, J, V)} is outside the "
                         "kernels' range")
    refusal = _smem_refusal(device.index, J)
    if refusal:
        raise ValueError(refusal)
    return True


def _dims(e, g, w):
    B, T, J = e.shape
    return B, T, g.shape[1], J, w.shape[1]


def rnnt_joint_fwd(e, g, w, b, labels):
    """e (B, T, J), g (B, U1, J), w (J, V), b (V,), labels (B, U1) ->
    (blank_lp, label_lp, lse), each (B, T, U1) float32."""
    global FWD_LAUNCHES
    if not _check(e, g, w, b, labels):
        return ref.rnnt_joint_fwd_ref(e, g, w, b, labels)
    B, T, U1, J, V = _dims(e, g, w)
    blank, label, lse = (torch.empty((B, T, U1), dtype=torch.float32, device=e.device)
                         for _ in range(3))
    stream = torch.cuda.current_stream(e.device).cuda_stream
    build.check_launch(
        _lib().rnnt_joint_fwd(_DTYPE_CODES[e.dtype], e.data_ptr(), g.data_ptr(), w.data_ptr(),
                              b.data_ptr(), labels.data_ptr(), blank.data_ptr(),
                              label.data_ptr(), lse.data_ptr(), B, T, U1, J, V, stream),
        "rnnt_joint_fwd")
    FWD_LAUNCHES += 1
    return blank, label, lse


def _bwd_eg(e, g, w, b, labels, lse, dblank, dlabel):
    """dpre (B, T, U1, J) float32, the gradient at tanh's input, through
    the eg kernel, on checked CUDA tensors."""
    global BWD_EG_LAUNCHES
    B, T, U1, J, V = _dims(e, g, w)
    dpre = torch.empty((B, T, U1, J), dtype=torch.float32, device=e.device)
    stream = torch.cuda.current_stream(e.device).cuda_stream
    build.check_launch(
        _lib().rnnt_joint_bwd_eg(_DTYPE_CODES[e.dtype], e.data_ptr(), g.data_ptr(),
                                 w.data_ptr(), b.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                                 dblank.data_ptr(), dlabel.data_ptr(), dpre.data_ptr(),
                                 B, T, U1, J, V, stream),
        "rnnt_joint_bwd_eg")
    BWD_EG_LAUNCHES += 1
    return dpre


def _bwd_reduce(dpre):
    """(de (B, T, J), dg (B, U1, J)) float32, the sums of dpre over U1
    and over T, through the reduce kernel, on a checked CUDA tensor."""
    global BWD_REDUCE_LAUNCHES
    B, T, U1, J = dpre.shape
    de = torch.empty((B, T, J), dtype=torch.float32, device=dpre.device)
    dg = torch.empty((B, U1, J), dtype=torch.float32, device=dpre.device)
    stream = torch.cuda.current_stream(dpre.device).cuda_stream
    build.check_launch(
        _lib().rnnt_joint_bwd_reduce(dpre.data_ptr(), de.data_ptr(), dg.data_ptr(),
                                     B, T, U1, J, stream),
        "rnnt_joint_bwd_reduce")
    BWD_REDUCE_LAUNCHES += 1
    return de, dg


def _bwd_w(e, g, w, b, labels, lse, dblank, dlabel):
    """(dw (J, V), db (V,)) float32 through the w kernel, on checked CUDA
    tensors."""
    global BWD_W_LAUNCHES
    B, T, U1, J, V = _dims(e, g, w)
    dw = torch.empty((J, V), dtype=torch.float32, device=e.device)
    db = torch.empty((V,), dtype=torch.float32, device=e.device)
    stream = torch.cuda.current_stream(e.device).cuda_stream
    build.check_launch(
        _lib().rnnt_joint_bwd_w(_DTYPE_CODES[e.dtype], e.data_ptr(), g.data_ptr(),
                                w.data_ptr(), b.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                                dblank.data_ptr(), dlabel.data_ptr(), dw.data_ptr(),
                                db.data_ptr(), B, T, U1, J, V, stream),
        "rnnt_joint_bwd_w")
    BWD_W_LAUNCHES += 1
    return dw, db


def rnnt_joint_bwd(e, g, w, b, labels, lse, dblank, dlabel):
    """The backward recomputed from the forward's lse: (de, dg, dw, db)
    in float32, for the cotangents (dblank, dlabel) of (blank_lp,
    label_lp)."""
    args = (e, g, w, b, labels, lse, dblank, dlabel)
    if not _check(*args):
        return ref.rnnt_joint_bwd_ref(*args)
    return (*_bwd_reduce(_bwd_eg(*args)), *_bwd_w(*args))


class RNNTJointFn(torch.autograd.Function):
    """The joint with its fused backward: saves (e, g, w, b, labels, lse)
    and recomputes the logits, as ``repro/kernels/ops.py:83-120`` does.
    The gradients come back in the inputs' dtypes; the labels get none."""

    @staticmethod
    def forward(ctx, e, g, w, b, labels):
        blank, label, lse = rnnt_joint_fwd(e, g, w, b, labels)
        ctx.save_for_backward(e, g, w, b, labels, lse)
        ctx.mark_non_differentiable(lse)
        return blank, label, lse

    @staticmethod
    def backward(ctx, dblank, dlabel, _dlse):
        e, g, w, b, labels, lse = ctx.saved_tensors
        de, dg, dw, db = rnnt_joint_bwd(e, g, w, b, labels, lse, dblank.contiguous(),
                                        dlabel.contiguous())
        return de.to(e.dtype), dg.to(g.dtype), dw.to(w.dtype), db.to(b.dtype), None


def rnnt_joint(e, g, w, b, labels):
    """The training-path entry point: (blank_lp, label_lp), each
    (B, T, U1) float32, differentiable in e, g, w and b."""
    blank, label, _ = RNNTJointFn.apply(e, g, w, b, labels)
    return blank, label
