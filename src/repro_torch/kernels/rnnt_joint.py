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
``FWD_H_LAUNCHES``, ``FWD_LOGITS_LAUNCHES`` and ``FWD_LSE_LAUNCHES`` (the
three kernels of K3; ``FWD_LAUNCHES`` counts its calls), and
``BWD_H_LAUNCHES``, ``BWD_DLOGITS_LAUNCHES``, ``BWD_DH_LAUNCHES``,
``BWD_REDUCE_LAUNCHES`` and ``BWD_DW_LAUNCHES`` (the five kernels of K4),
so that a run can show that its joint went through every one of them.
Both allocate scratch in fp32 a call, live only inside the call: K3 h (B,
T, U1, J) and the logits (B, T, U1, V), 160,038,912 B at the paper-width
client step (B=4, T'=64, U1=33, J=640, V=4,096); K4 h, dlogits (B, T, U1,
V) and dh_fix (B, T, U1, 2), 160,106,496 B.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

FWD_LAUNCHES = 0
FWD_H_LAUNCHES = 0
FWD_LOGITS_LAUNCHES = 0
FWD_LSE_LAUNCHES = 0
BWD_H_LAUNCHES = 0
BWD_DLOGITS_LAUNCHES = 0
BWD_DH_LAUNCHES = 0
BWD_REDUCE_LAUNCHES = 0
BWD_DW_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# rows of the products' tiles, and the most tiles a grid's y axis holds
_TILE_ROWS, _GRID_Y = 64, 65535
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("rnnt_joint")
    lib.rnnt_joint_h.argtypes = [_I] + [_P] * 3 + [_I] * 4 + [_P]
    lib.rnnt_joint_fwd_logits.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    lib.rnnt_joint_fwd_lse.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.rnnt_joint_bwd_dlogits.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    lib.rnnt_joint_bwd_dh.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    lib.rnnt_joint_bwd_reduce.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    lib.rnnt_joint_bwd_dw.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    for fn in (lib.rnnt_joint_h, lib.rnnt_joint_fwd_logits, lib.rnnt_joint_fwd_lse,
               lib.rnnt_joint_bwd_dlogits, lib.rnnt_joint_bwd_dh, lib.rnnt_joint_bwd_reduce,
               lib.rnnt_joint_bwd_dw):
        fn.restype = _I
    return lib


def _check(e, g, w, b, labels, lse=None, dblank=None, dlabel=None) -> bool:
    """Validate shapes and types; True when the kernels must run (CUDA),
    False for the plain version (CPU). Raises on anything else. The
    kernels index the (N, V) scratch (the logits, dlogits) in 64 bits;
    the range below keeps N·J and J·V inside int32 and N = B·T·U1 rows,
    64 a tile, inside the products' grid."""
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
    if min(B, T, U1, J, V) == 0 or B * T * U1 * J >= 2**31 or J * V >= 2**31 \
            or -(-B * T * U1 // _TILE_ROWS) > _GRID_Y:
        raise ValueError(f"shape (B, T, U1, J, V) = {(B, T, U1, J, V)} is outside the "
                         "kernels' range")
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _h(e, g, U1):
    """h (B, T, U1, J) float32 = tanh(e + g) through the h kernel, on
    checked CUDA tensors (the plain version: ``ref.rnnt_joint_h_ref``).
    The callers count the launch."""
    B, T, J = e.shape
    h = torch.empty((B, T, U1, J), dtype=torch.float32, device=e.device)
    build.check_launch(
        _lib().rnnt_joint_h(_DTYPE_CODES[e.dtype], e.data_ptr(), g.data_ptr(), h.data_ptr(),
                            B, T, U1, J, _stream(e)),
        "rnnt_joint_h")
    return h


def _fwd_h(e, g, U1):
    """K3's first launch: h through the h kernel."""
    global FWD_H_LAUNCHES
    h = _h(e, g, U1)
    FWD_H_LAUNCHES += 1
    return h


def _fwd_logits(h, w, b):
    """The logits (B, T, U1, V) float32 = h·w + b through the logits
    kernel, on checked CUDA tensors (``ref.rnnt_joint_logits_ref``)."""
    global FWD_LOGITS_LAUNCHES
    B, T, U1, J = h.shape
    V = w.shape[1]
    logits = torch.empty((B, T, U1, V), dtype=torch.float32, device=h.device)
    build.check_launch(
        _lib().rnnt_joint_fwd_logits(h.data_ptr(), w.data_ptr(), b.data_ptr(),
                                     logits.data_ptr(), B, T, U1, J, V, _stream(h)),
        "rnnt_joint_fwd_logits")
    FWD_LOGITS_LAUNCHES += 1
    return logits


def _fwd_lse(logits, labels):
    """(blank_lp, label_lp, lse), each (B, T, U1) float32, from the
    logits through the log-sum-exp kernel, on checked CUDA tensors
    (``ref.rnnt_joint_lse_ref``)."""
    global FWD_LSE_LAUNCHES
    B, T, U1, V = logits.shape
    blank, label, lse = (torch.empty((B, T, U1), dtype=torch.float32, device=logits.device)
                         for _ in range(3))
    build.check_launch(
        _lib().rnnt_joint_fwd_lse(logits.data_ptr(), labels.data_ptr(), blank.data_ptr(),
                                  label.data_ptr(), lse.data_ptr(), B, T, U1, V,
                                  _stream(logits)),
        "rnnt_joint_fwd_lse")
    FWD_LSE_LAUNCHES += 1
    return blank, label, lse


def rnnt_joint_fwd(e, g, w, b, labels):
    """e (B, T, J), g (B, U1, J), w (J, V), b (V,), labels (B, U1) ->
    (blank_lp, label_lp, lse), each (B, T, U1) float32. On the card three
    launches: h, the logits, their log-sum-exp."""
    global FWD_LAUNCHES
    if not _check(e, g, w, b, labels):
        return ref.rnnt_joint_fwd_ref(e, g, w, b, labels)
    out = _fwd_lse(_fwd_logits(_fwd_h(e, g, labels.shape[1]), w, b), labels)
    FWD_LAUNCHES += 1
    return out


def _bwd_h(e, g, U1):
    """K4's first launch: h through the h kernel."""
    global BWD_H_LAUNCHES
    h = _h(e, g, U1)
    BWD_H_LAUNCHES += 1
    return h


def _bwd_dlogits(h, w, b, labels, lse, dblank, dlabel):
    """(dlogits (B, T, U1, V), dh_fix (B, T, U1, 2)) float32 through the
    dlogits kernel, on checked CUDA tensors: dlogits as
    ``ref.rnnt_joint_dlogits_ref``, and dh's operand at v=0 and at the
    label, which the design before rounded otherwise (csrc/rnnt_joint.cu,
    ``dlogit_dh``)."""
    global BWD_DLOGITS_LAUNCHES
    B, T, U1, J = h.shape
    V = w.shape[1]
    dlogits = torch.empty((B, T, U1, V), dtype=torch.float32, device=h.device)
    dh_fix = torch.empty((B, T, U1, 2), dtype=torch.float32, device=h.device)
    build.check_launch(
        _lib().rnnt_joint_bwd_dlogits(h.data_ptr(), w.data_ptr(), b.data_ptr(),
                                      labels.data_ptr(), lse.data_ptr(), dblank.data_ptr(),
                                      dlabel.data_ptr(), dlogits.data_ptr(), dh_fix.data_ptr(),
                                      B, T, U1, J, V, _stream(h)),
        "rnnt_joint_bwd_dlogits")
    BWD_DLOGITS_LAUNCHES += 1
    return dlogits, dh_fix


def _bwd_dh(dlogits, dh_fix, labels, w, h):
    """dpre (B, T, U1, J) float32, the gradient at tanh's input, through
    the dh kernel, on checked CUDA tensors (``ref.rnnt_joint_dpre_ref``)."""
    global BWD_DH_LAUNCHES
    B, T, U1, J = h.shape
    dpre = torch.empty_like(h)
    build.check_launch(
        _lib().rnnt_joint_bwd_dh(dlogits.data_ptr(), dh_fix.data_ptr(), labels.data_ptr(),
                                 w.data_ptr(), h.data_ptr(), dpre.data_ptr(), B, T, U1, J,
                                 w.shape[1], _stream(h)),
        "rnnt_joint_bwd_dh")
    BWD_DH_LAUNCHES += 1
    return dpre


def _bwd_reduce(dpre):
    """(de (B, T, J), dg (B, U1, J)) float32, the sums of dpre over U1
    and over T, through the reduce kernel, on a checked CUDA tensor
    (``ref.rnnt_joint_bwd_reduce_ref``)."""
    global BWD_REDUCE_LAUNCHES
    B, T, U1, J = dpre.shape
    de = torch.empty((B, T, J), dtype=torch.float32, device=dpre.device)
    dg = torch.empty((B, U1, J), dtype=torch.float32, device=dpre.device)
    build.check_launch(
        _lib().rnnt_joint_bwd_reduce(dpre.data_ptr(), de.data_ptr(), dg.data_ptr(),
                                     B, T, U1, J, _stream(dpre)),
        "rnnt_joint_bwd_reduce")
    BWD_REDUCE_LAUNCHES += 1
    return de, dg


def _bwd_dw(h, dlogits):
    """(dw (J, V), db (V,)) float32 through the dw kernel, on checked CUDA
    tensors (``ref.rnnt_joint_dw_ref``)."""
    global BWD_DW_LAUNCHES
    B, T, U1, J = h.shape
    V = dlogits.shape[-1]
    dw = torch.empty((J, V), dtype=torch.float32, device=h.device)
    db = torch.empty((V,), dtype=torch.float32, device=h.device)
    build.check_launch(
        _lib().rnnt_joint_bwd_dw(h.data_ptr(), dlogits.data_ptr(), dw.data_ptr(), db.data_ptr(),
                                 B, T, U1, J, V, _stream(h)),
        "rnnt_joint_bwd_dw")
    BWD_DW_LAUNCHES += 1
    return dw, db


def rnnt_joint_bwd(e, g, w, b, labels, lse, dblank, dlabel):
    """The backward recomputed from the forward's lse: (de, dg, dw, db)
    in float32, for the cotangents (dblank, dlabel) of (blank_lp,
    label_lp). On the card five launches: h, dlogits, dpre, its sums, and
    dW with db."""
    args = (e, g, w, b, labels, lse, dblank, dlabel)
    if not _check(*args):
        return ref.rnnt_joint_bwd_ref(*args)
    h = _bwd_h(e, g, labels.shape[1])
    dlogits, dh_fix = _bwd_dlogits(h, w, b, labels, lse, dblank, dlabel)
    return (*_bwd_reduce(_bwd_dh(dlogits, dh_fix, labels, w, h)), *_bwd_dw(h, dlogits))


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
