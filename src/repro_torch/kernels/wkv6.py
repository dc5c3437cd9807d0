"""The WKV-6 recurrence kernel (K12): wrapper, autograd Function and launch
counts.

Replaces no Pallas kernel: the reference runs RWKV-6's recurrence as a
``lax.scan`` of checkpointed 64-step chunks (``repro/models/rwkv.py:140``,
its step ``:126-131``). The kernels are CUDA C++ in ``csrc/wkv6.cu`` (its
header states what bounds them), built by ``build.py`` and called through
ctypes: ``wkv6_fwd`` is one launch (``wkv6_fwd_lanes_kernel<P>``) over a
layer's whole sequence (training from a zero state, prefill, and the
one-token decode step from the cache's state): each column of the state
over P/8 lanes, a thread 8 entries of each of 2 columns, a (b, h) over
P/32 blocks of at most 32 columns, its inputs as TMA boxes a sub-chunk of 8 steps at a time, no
barrier a step (``fwd_geometry`` its block). ``wkv6_bwd`` is two:
``wkv6_bwd_kernel<P>`` walks the recurrence back from the forward's
checkpoints, each 64-step chunk replayed on chip in 8-step sub-chunks (its
inputs as TMA boxes on mbarriers, its states in shared memory and
registers: no scratch in device memory, ``bwd_geometry`` its block), then
``wkv6_du_sum_kernel`` adds du over the batch rows in order.

``wkv6`` is what the model calls: under autograd (grad mode on and an
input that requires grad) it runs ``WKV6Function``, whose forward keeps
the state every ``CHUNK`` steps (the reference's chunk: saving every
step's state would cost 268 MB a layer at rwkv6-1.6b's B=4, S=128) and
whose backward replays each chunk. Otherwise the forward runs alone,
without checkpoints. The wrappers take the plain versions
(``ref.wkv6_fwd_ref``, ``ref.wkv6_bwd_ref``: the same algorithm in
PyTorch) only for tensors on the CPU; a CUDA tensor gets the kernel or an
exception. ``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import check_devices

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
CHUNK = 64               # steps between the forward's checkpoints
HEAD_SIZES = (16, 32, 64)  # the kernels' template instantiations
# the kernels' layout (csrc/scan.cuh): entries a thread, steps a sub-chunk,
# the backward's input slabs and sub-checkpoint slots, the forward's input
# slabs, lines a block at most and columns a thread at most
SPAN, SUB, SLABS, SUB_SLOTS = 8, 8, 4, CHUNK // 8 - 2
FWD_SLABS, FWD_LINES, FWD_COLS = 4, 32, 2
SMEM_LIMIT = 232_448     # shared bytes a block can have on an H100
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("wkv6")
    lib.wkv6_fwd.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    lib.wkv6_fwd.restype = _I
    lib.wkv6_bwd.argtypes = [_P] * 15 + [_I] * 5 + [_P]
    lib.wkv6_bwd.restype = _I
    lib.wkv6_bwd_info.argtypes = lib.wkv6_fwd_info.argtypes = [_I, _P]
    lib.wkv6_bwd_info.restype = lib.wkv6_fwd_info.restype = _I
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(what: str, r, k, v, w, u, *states) -> bool:
    """Shapes always; on the card fp32, contiguous and a head size the
    kernels take. True when the tensors lie on the card."""
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"{what}: r, k, v and w must share one (B, S, H, P) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, P = r.shape
    if tuple(u.shape) != (H, P):
        raise ValueError(f"{what}: u must be (H, P) = {(H, P)}, got {tuple(u.shape)}")
    tensors = [r, k, v, w, u, *(t for t in states if t is not None)]
    on_card = check_devices(what, *tensors)
    if on_card:
        if any(t.dtype != torch.float32 for t in tensors):
            raise TypeError(f"{what}: the kernel takes float32, got "
                            f"{sorted({str(t.dtype) for t in tensors})}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError(f"{what}: the kernel takes contiguous tensors")
        if P not in HEAD_SIZES or S == 0:
            raise ValueError(f"{what}: the kernel takes P in {HEAD_SIZES} and S >= 1; got "
                             f"P={P}, S={S}")
    return on_card


def bwd_geometry(P: int) -> dict:
    """The backward kernel's block at head size P, as ``Wkv6Bwd<P>`` in
    ``csrc/wkv6.cu`` lays it out: threads (P·P / 8, 8 state entries each),
    warps and dynamic shared bytes (the slabs of r, k, w, v, dy, the
    sub-checkpoints, two sub-chunks' partial tiles, u, the mbarriers; 128
    bytes more to align the start for TMA)."""
    if P not in HEAD_SIZES:
        raise ValueError(f"wkv6_bwd: the kernel takes P in {HEAD_SIZES}, got {P}")
    threads = P * P // SPAN
    warps = threads // 32
    floats = (SLABS * 5 * SUB * P + SUB_SLOTS * SPAN * threads + 2 * SUB * warps * P
              + 2 * SUB * 4 * P + P)
    return {"threads": threads, "warps": warps, "shared_bytes": 128 + 4 * floats + 8 * SLABS}


def bwd_info(P: int) -> dict:
    """The built backward kernel at head size P on the current card:
    threads, dynamic shared bytes, registers a thread, blocks an SM and
    spilled bytes a thread (``wkv6_bwd_info``)."""
    info = build.kernel_info(_lib(), "wkv6_bwd_info", P)
    del info["blocks"]
    return info


def fwd_geometry(P: int) -> dict:
    """The forward kernel's block at head size P, as ``Wkv6Fwd<P>`` in
    ``csrc/wkv6.cu`` lays it out: a block holds ``min(P, FWD_LINES)``
    columns of the state, each over P/8 lanes, a thread 8 entries of each
    of up to FWD_COLS columns (threads: as many as whole warps allow),
    ``blocks`` blocks a (b, h), and dynamic shared bytes (the slabs of r, k, w and the
    block's v, the state tile, two sub-chunks' y tiles of 4 floats more a
    row, the mbarriers; 128 bytes more to align the start for TMA)."""
    if P not in HEAD_SIZES:
        raise ValueError(f"wkv6_fwd: the kernel takes P in {HEAD_SIZES}, got {P}")
    lines = min(P, FWD_LINES)
    cols = min(FWD_COLS, lines * P // SPAN // 32)
    floats = FWD_SLABS * SUB * (3 * P + lines) + P * lines + 2 * SUB * (lines + 4)
    return {"threads": lines * P // SPAN // cols, "blocks": P // lines,
            "shared_bytes": 128 + 4 * floats + 8 * FWD_SLABS}


def fwd_info(P: int) -> dict:
    """The built forward kernel at head size P on the current card: threads,
    dynamic shared bytes, registers a thread, blocks an SM, spilled bytes a
    thread and blocks a (b, h) (``wkv6_fwd_info``)."""
    return build.kernel_info(_lib(), "wkv6_fwd_info", P)


def _aligned(t):
    """``t``, or a copy where its start is not 16-byte aligned: the forward
    reads its inputs as TMA boxes and the state 16 bytes at a time (a
    cache's view may start anywhere)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _check_aligned(what: str, *tensors) -> None:
    """The backward reads its inputs as TMA boxes and the state's rows 16
    bytes at a time."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the kernel takes 16-byte-aligned tensors")


def wkv6_fwd(r, k, v, w, u, S0=None, *, checkpoints: bool = False):
    """r, k, v, w (B, S, H, P) fp32, u (H, P), S0 (B, H, P, P) or None (a
    zero state) -> (y (B, S, H, P), S_T, the checkpoints (B, H, ceil(S /
    CHUNK), P, P) or None). One launch on the card; an input that does not
    start on 16 bytes is copied first."""
    global FWD_LAUNCHES
    B, S, H, P = r.shape
    if S0 is not None and tuple(S0.shape) != (B, H, P, P):
        raise ValueError(f"wkv6: S0 must be {(B, H, P, P)}, got {tuple(S0.shape)}")
    if not _check("wkv6", r, k, v, w, u, S0):
        y, ST, ckpt = ref.wkv6_fwd_ref(r, k, v, w, u, S0, CHUNK)
        return y, ST, ckpt if checkpoints else None
    r, k, v, w, u, S0 = (_aligned(t) for t in (r, k, v, w, u, S0))
    y = torch.empty_like(r)
    ST = torch.empty((B, H, P, P), dtype=torch.float32, device=r.device)
    ckpt = torch.empty((B, H, -(-S // CHUNK), P, P), dtype=torch.float32,
                       device=r.device) if checkpoints else None
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check_launch(_lib().wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), _ptr(S0),
        y.data_ptr(), ST.data_ptr(), _ptr(ckpt), B, S, H, P, CHUNK, stream), "wkv6_fwd")
    FWD_LAUNCHES += 1
    return y, ST, ckpt


def wkv6_bwd(r, k, v, w, u, ckpt, dy, dS_T=None, *, want_dS0: bool = True):
    """The gradients of ``wkv6_fwd``'s (y, S_T) from its checkpoints: (dr,
    dk, dv, dw (B, S, H, P), du (H, P), dS0 (B, H, P, P) or None). ``dS_T``
    None is a zero cotangent. Two launches on the card
    (``wkv6_bwd_kernel<P>``, ``wkv6_du_sum_kernel``), which allocate no
    scratch; the inputs must be 16-byte aligned (TMA)."""
    global BWD_LAUNCHES
    B, S, H, P = r.shape
    n_ck = -(-S // CHUNK)
    if tuple(ckpt.shape) != (B, H, n_ck, P, P) or dy.shape != r.shape or \
            (dS_T is not None and tuple(dS_T.shape) != (B, H, P, P)):
        raise ValueError(f"wkv6_bwd: checkpoints {tuple(ckpt.shape)}, dy {tuple(dy.shape)} "
                         f"do not fit r {tuple(r.shape)}")
    if not _check("wkv6_bwd", r, k, v, w, u, ckpt, dy, dS_T):
        dr, dk, dv, dw, du, dS0 = ref.wkv6_bwd_ref(r, k, v, w, u, ckpt, dy, dS_T, CHUNK)
        return dr, dk, dv, dw, du, dS0 if want_dS0 else None
    _check_aligned("wkv6_bwd", r, k, v, w, ckpt, dy, dS_T)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_rows = torch.empty((B, H, P), dtype=torch.float32, device=r.device)
    du = torch.empty((H, P), dtype=torch.float32, device=r.device)
    dS0 = torch.empty((B, H, P, P), dtype=torch.float32, device=r.device) if want_dS0 else None
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check_launch(_lib().wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), ckpt.data_ptr(),
        dy.data_ptr(), _ptr(dS_T), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du_rows.data_ptr(), du.data_ptr(), _ptr(dS0), B, S, H, P, CHUNK, stream), "wkv6_bwd")
    BWD_LAUNCHES += 1
    return dr, dk, dv, dw, du, dS0


class WKV6Function(torch.autograd.Function):
    """K12 under autograd: the forward keeps its inputs and checkpoints, the
    backward launches ``wkv6_bwd`` on them (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, S0):
        y, ST, ckpt = wkv6_fwd(r, k, v, w, u, S0, checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.set_materialize_grads(False)  # an unused S_T's cotangent stays None
        return y, ST

    @staticmethod
    def backward(ctx, dy, dS_T):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        dr, dk, dv, dw, du, dS0 = wkv6_bwd(
            r, k, v, w, u, ckpt, dy,
            None if dS_T is None else dS_T.contiguous(), want_dS0=ctx.needs_input_grad[5])
        return dr, dk, dv, dw, du, dS0


def wkv6(r, k, v, w, u, S0=None):
    """The model's call: (y, S_T) of the recurrence, differentiable
    (``WKV6Function``) when autograd needs it. Inputs as ``wkv6_fwd``'s;
    they are made contiguous here."""
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    S0 = None if S0 is None else S0.contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, w, u, S0)):
        return WKV6Function.apply(r, k, v, w, u, S0)
    y, ST, _ = wkv6_fwd(r, k, v, w, u, S0)
    return y, ST
