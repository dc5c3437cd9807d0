"""The Mamba2 recurrence kernel (K13): wrapper, autograd Function and launch
counts.

Replaces no Pallas kernel: the reference runs Mamba2's recurrence as a
``lax.scan`` of checkpointed 64-step chunks in ``mamba_forward``
(``repro/models/ssm.py:122``, its step ``:110-116``) and as one jnp step in
``mamba_step`` (``:147-166``). The kernels are CUDA C++ in
``csrc/ssm_scan.cu`` (its header states what bounds them), built by
``build.py`` and called through ctypes: ``ssm_scan_fwd`` is one launch
(``ssm_scan_fwd_lanes_kernel<P, N>``) over a layer's sequence (S = 1 is
the decode step, from the cache's state): each row of the state over N/8
lanes, a thread 8 entries of each of up to 4 rows, a (b, h) over P/32
blocks of at most 32 rows,
its inputs as TMA boxes a sub-chunk of 8 steps at a time, no barrier a
step (``fwd_geometry`` its block). ``ssm_scan_bwd`` is two:
``ssm_scan_bwd_kernel<P, N>`` walks the recurrence back from the forward's
checkpoints, each 64-step chunk replayed on chip in 8-step sub-chunks (its
inputs as TMA boxes on mbarriers, its states in shared memory and
registers: no scratch in device memory, ``bwd_geometry`` its block), then
``ssm_scan_bc_sum_kernel`` adds dB and dC over the heads in a fixed order (B and C
are shared by the heads).

``ssm_scan`` is what the model calls: under autograd it runs
``SSMScanFunction`` (the forward keeps the state every ``CHUNK`` steps,
the backward replays each chunk), otherwise the forward alone. The
wrappers take the plain versions (``ref.ssm_scan_fwd_ref``,
``ref.ssm_scan_bwd_ref``: the same algorithm in PyTorch) only for tensors
on the CPU; a CUDA tensor gets the kernel or an exception.
``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import check_devices

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
CHUNK = 64              # steps between the forward's checkpoints
WIDTHS = (16, 32, 64)   # the kernels' template instantiations: the state's N and P
# the kernels' layout (csrc/scan.cuh): entries a thread, steps a sub-chunk,
# the backward's input slabs and sub-checkpoint slots, the forward's input
# slabs, lines a block at most and rows a thread at most
SPAN, SUB, SLABS, SUB_SLOTS = 8, 8, 4, CHUNK // 8 - 2
FWD_SLABS, FWD_LINES, FWD_ROWS = 4, 32, 4
SMEM_LIMIT = 232_448    # shared bytes a block can have on an H100
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssm_scan")
    lib.ssm_scan_fwd.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    lib.ssm_scan_fwd.restype = _I
    lib.ssm_scan_bwd.argtypes = [_P] * 16 + [_I] * 6 + [_P]
    lib.ssm_scan_bwd.restype = _I
    lib.ssm_scan_bwd_info.argtypes = lib.ssm_scan_fwd_info.argtypes = [_I, _I, _P]
    lib.ssm_scan_bwd_info.restype = lib.ssm_scan_fwd_info.restype = _I
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(what: str, x, dt, a, Bm, Cm, *states) -> bool:
    """Shapes always; on the card fp32, contiguous and widths the kernels
    take. True when the tensors lie on the card."""
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"{what}: x must be (B, S, H, P) and B, C (B, S, N)")
    Bsz, S, H, P = x.shape
    if tuple(dt.shape) != (Bsz, S, H) or tuple(a.shape) != (Bsz, S, H) or \
            Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (Bsz, S):
        raise ValueError(f"{what}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)} do not "
                         "agree")
    tensors = [x, dt, a, Bm, Cm, *(t for t in states if t is not None)]
    on_card = check_devices(what, *tensors)
    if on_card:
        if any(t.dtype != torch.float32 for t in tensors):
            raise TypeError(f"{what}: the kernel takes float32, got "
                            f"{sorted({str(t.dtype) for t in tensors})}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError(f"{what}: the kernel takes contiguous tensors")
        N = Bm.shape[-1]
        if P not in WIDTHS or N not in WIDTHS or S == 0:
            raise ValueError(f"{what}: the kernel takes P and N in {WIDTHS} and S >= 1; got "
                             f"P={P}, N={N}, S={S}")
    return on_card


def bwd_geometry(P: int, N: int) -> dict:
    """The backward kernel's block at widths P and N, as ``SsmBwd<P, N>`` in
    ``csrc/ssm_scan.cu`` lays it out: threads (N·P / 8, 8 state entries
    each), warps and dynamic shared bytes (the slabs of x, dy, B, C, the
    sub-checkpoints, two sub-chunks' partial tiles, a chunk's a and dt
    twice, the mbarriers; 128 bytes more to align the start for TMA)."""
    if P not in WIDTHS or N not in WIDTHS:
        raise ValueError(f"ssm_scan_bwd: the kernel takes P and N in {WIDTHS}, got P={P}, N={N}")
    threads = N * P // SPAN
    warps = threads // 32
    floats = (SLABS * 2 * SUB * (P + N) + SUB_SLOTS * SPAN * threads + 2 * SUB * warps * P
              + 2 * SUB * 3 * N + 4 * CHUNK)
    return {"threads": threads, "warps": warps, "shared_bytes": 128 + 4 * floats + 8 * SLABS}


def bwd_info(P: int, N: int) -> dict:
    """The built backward kernel at widths P and N on the current card:
    threads, dynamic shared bytes, registers a thread, blocks an SM and
    spilled bytes a thread (``ssm_scan_bwd_info``)."""
    info = build.kernel_info(_lib(), "ssm_scan_bwd_info", P, N)
    del info["blocks"]
    return info


def fwd_geometry(P: int, N: int) -> dict:
    """The forward kernel's block at widths P and N, as ``SsmFwd<P, N>`` in
    ``csrc/ssm_scan.cu`` lays it out: a block holds ``min(P, FWD_LINES)``
    rows of the state, each over N/8 lanes, a thread 8 entries of each of
    up to FWD_ROWS rows (threads: as many as whole warps allow), ``blocks``
    blocks a (b, h), and dynamic shared bytes (the slabs of the block's x, B and C,
    two sub-chunks' y tiles of 4 floats more a row, two chunks' a and dt,
    the mbarriers; 128 bytes more to align the start for TMA)."""
    if P not in WIDTHS or N not in WIDTHS:
        raise ValueError(f"ssm_scan_fwd: the kernel takes P and N in {WIDTHS}, got P={P}, "
                         f"N={N}")
    lines = min(P, FWD_LINES)
    rows = min(FWD_ROWS, lines * N // SPAN // 32)
    floats = FWD_SLABS * SUB * (lines + 2 * N) + 2 * SUB * (lines + 4) + 4 * CHUNK
    return {"threads": lines * N // SPAN // rows, "blocks": P // lines,
            "shared_bytes": 128 + 4 * floats + 8 * FWD_SLABS}


def fwd_info(P: int, N: int) -> dict:
    """The built forward kernel at widths P and N on the current card:
    threads, dynamic shared bytes, registers a thread, blocks an SM, spilled
    bytes a thread and blocks a (b, h) (``ssm_scan_fwd_info``)."""
    return build.kernel_info(_lib(), "ssm_scan_fwd_info", P, N)


def _aligned(t):
    """``t``, or a copy where its start is not 16-byte aligned: the forward
    reads x, B and C as TMA boxes and the state 16 bytes at a time (a
    cache's view may start anywhere)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _check_aligned(what: str, *tensors) -> None:
    """The backward reads x, dy, B and C as TMA boxes."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the kernel takes 16-byte-aligned tensors")


def ssm_scan_fwd(x, dt, a, Bm, Cm, h0=None, *, checkpoints: bool = False):
    """x (B, S, H, P), dt and a (B, S, H), Bm and Cm (B, S, N), all fp32,
    h0 (B, H, P, N) or None (a zero state) -> (y (B, S, H, P), h_T, the
    checkpoints (B, H, ceil(S / CHUNK), P, N) or None). One launch on the
    card; an input that does not start on 16 bytes is copied first."""
    global FWD_LAUNCHES
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if h0 is not None and tuple(h0.shape) != (Bsz, H, P, N):
        raise ValueError(f"ssm_scan: h0 must be {(Bsz, H, P, N)}, got {tuple(h0.shape)}")
    if not _check("ssm_scan", x, dt, a, Bm, Cm, h0):
        y, hT, ckpt = ref.ssm_scan_fwd_ref(x, dt, a, Bm, Cm, h0, CHUNK)
        return y, hT, ckpt if checkpoints else None
    x, Bm, Cm, h0 = (_aligned(t) for t in (x, Bm, Cm, h0))
    y = torch.empty_like(x)
    hT = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ckpt = torch.empty((Bsz, H, -(-S // CHUNK), P, N), dtype=torch.float32,
                       device=x.device) if checkpoints else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check_launch(_lib().ssm_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), _ptr(h0),
        y.data_ptr(), hT.data_ptr(), _ptr(ckpt), Bsz, S, H, P, N, CHUNK, stream),
        "ssm_scan_fwd")
    FWD_LAUNCHES += 1
    return y, hT, ckpt


def ssm_scan_bwd(x, dt, a, Bm, Cm, ckpt, dy, dh_T=None, *, want_dh0: bool = True):
    """The gradients of ``ssm_scan_fwd``'s (y, h_T) from its checkpoints:
    (dx, ddt, da, dB, dC, dh0 or None), each shaped as its input. ``dh_T``
    None is a zero cotangent. Two launches on the card
    (``ssm_scan_bwd_kernel<P, N>``, ``ssm_scan_bc_sum_kernel``), which
    allocate no scratch; x, dy, B and C must be 16-byte aligned (TMA)."""
    global BWD_LAUNCHES
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(ckpt.shape) != (Bsz, H, -(-S // CHUNK), P, N) or dy.shape != x.shape or \
            (dh_T is not None and tuple(dh_T.shape) != (Bsz, H, P, N)):
        raise ValueError(f"ssm_scan_bwd: checkpoints {tuple(ckpt.shape)}, dy "
                         f"{tuple(dy.shape)} do not fit x {tuple(x.shape)}")
    if not _check("ssm_scan_bwd", x, dt, a, Bm, Cm, ckpt, dy, dh_T):
        dx, ddt, da, dB, dC, dh0 = ref.ssm_scan_bwd_ref(x, dt, a, Bm, Cm, ckpt, dy, dh_T, CHUNK)
        return dx, ddt, da, dB, dC, dh0 if want_dh0 else None
    _check_aligned("ssm_scan_bwd", x, dy, Bm, Cm)
    dx = torch.empty_like(x)
    ddt, da = torch.empty_like(dt), torch.empty_like(a)
    dB_heads = torch.empty((Bsz, S, H, N), dtype=torch.float32, device=x.device)
    dC_heads = torch.empty_like(dB_heads)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dh0 = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device) if want_dh0 \
        else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check_launch(_lib().ssm_scan_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), ckpt.data_ptr(),
        dy.data_ptr(), _ptr(dh_T), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
        dB_heads.data_ptr(), dC_heads.data_ptr(), dB.data_ptr(), dC.data_ptr(), _ptr(dh0),
        Bsz, S, H, P, N, CHUNK, stream), "ssm_scan_bwd")
    BWD_LAUNCHES += 1
    return dx, ddt, da, dB, dC, dh0


class SSMScanFunction(torch.autograd.Function):
    """K13 under autograd: the forward keeps its inputs and checkpoints, the
    backward launches ``ssm_scan_bwd`` on them (the plain versions on the
    CPU)."""

    @staticmethod
    def forward(ctx, x, dt, a, Bm, Cm, h0):
        y, hT, ckpt = ssm_scan_fwd(x, dt, a, Bm, Cm, h0, checkpoints=True)
        ctx.save_for_backward(x, dt, a, Bm, Cm, ckpt)
        ctx.set_materialize_grads(False)  # an unused h_T's cotangent stays None
        return y, hT

    @staticmethod
    def backward(ctx, dy, dh_T):
        x, dt, a, Bm, Cm, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        return ssm_scan_bwd(x, dt, a, Bm, Cm, ckpt, dy,
                            None if dh_T is None else dh_T.contiguous(),
                            want_dh0=ctx.needs_input_grad[5])


def ssm_scan(x, dt, a, Bm, Cm, h0=None):
    """The model's call: (y, h_T) of the recurrence, differentiable
    (``SSMScanFunction``) when autograd needs it. Inputs as
    ``ssm_scan_fwd``'s; they are made contiguous here."""
    x, dt, a, Bm, Cm = (t.contiguous() for t in (x, dt, a, Bm, Cm))
    h0 = None if h0 is None else h0.contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, a, Bm, Cm, h0)):
        return SSMScanFunction.apply(x, dt, a, Bm, Cm, h0)
    y, hT, _ = ssm_scan_fwd(x, dt, a, Bm, Cm, h0)
    return y, hT
