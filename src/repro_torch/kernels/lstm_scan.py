"""The full-sequence LSTM recurrence kernel (K2): wrappers and autograd.

Replaces the Pallas TPU kernels ``repro/kernels/lstm_gates.py:202
lstm_scan_fused`` and ``:295 lstm_scan_bwd_fused``, joined there by
``lstm_scan_fused_vjp``. The kernels are CUDA C++ in
``csrc/lstm_scan.cu`` (its header states what bounds them on the card),
built by ``build.py`` and called through ctypes: the forward scan, the
backward's gate recompute, the backward recurrence and the ``dw_hh``
product, each with its launch counter (``SCAN_FWD_LAUNCHES``,
``SCAN_BWD_GATES_LAUNCHES``, ``SCAN_BWD_LAUNCHES``,
``SCAN_DW_LAUNCHES``). The forward and the backward recurrence each have
a timed instantiation that records the time of each phase of a step
(``lstm_scan_fwd_phases``, ``lstm_scan_bwd_phases``).

Everything is time-major, (S, B, ...), as in the TPU kernels. A wrapper
takes the plain version (``ref.py``) only for tensors on the CPU. A CUDA
tensor gets the kernel or an exception, also when the grid cannot be
resident all at once; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

SCAN_FWD_LAUNCHES = 0
SCAN_BWD_GATES_LAUNCHES = 0
SCAN_BWD_LAUNCHES = 0
SCAN_DW_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "the block's slice of w_hh does not fit the card's shared memory",
           -2: "the grid cannot be resident on the card all at once"}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("lstm_scan")
    lib.lstm_scan_fwd.argtypes = [_I] + [_P] * 8 + [_I, _I, _I, _I, _P]
    lib.lstm_scan_bwd_gates.argtypes = [_I] + [_P] * 6 + [_I, _I, _I, _I, _P]
    lib.lstm_scan_bwd.argtypes = [_I] + [_P] * 11 + [_I, _I, _I, _I, _P]
    lib.lstm_scan_dw.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.lstm_scan_dw_blocks_per_sm.argtypes = [_I, _I, ctypes.POINTER(_I)]
    for fn in (lib.lstm_scan_fwd, lib.lstm_scan_bwd_gates, lib.lstm_scan_bwd, lib.lstm_scan_dw,
               lib.lstm_scan_dw_blocks_per_sm):
        fn.restype = _I
    for fn in (lib.lstm_scan_bwd_gates_floats, lib.lstm_scan_bwd_scratch_floats):
        fn.argtypes = [_I, _I, _I, _I]
        fn.restype = ctypes.c_longlong
    return lib


def _launch(err: int, what: str) -> None:
    if err in _ERRORS:
        raise RuntimeError(f"{what}: {_ERRORS[err]}")
    build.check_launch(err, what)


@functools.cache
def _units_per_block(device_index: int, H: int) -> int:
    """Hidden units per block: the fewest that put one block on each SM
    at most, ceil(H / SMs) (9 at H=1152 on 132 SMs, 128 blocks)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return -(-H // sms)


def _check(xg, w_hh, h0, c0, seq=(), rows=(), fp32=()) -> bool:
    """Validate shapes, devices and types; True when the kernel must run
    (CUDA), False for the plain version (CPU). ``seq`` are further
    (S, B, H) tensors in xg's dtype, ``rows`` (B, H) tensors in xg's
    dtype, ``fp32`` (S, B, H) or (B, H) fp32 tensors."""
    if xg.dim() != 3 or xg.shape[2] % 4:
        raise ValueError(f"xg must be (S, B, 4H), got {tuple(xg.shape)}")
    S, B, H = xg.shape[0], xg.shape[1], xg.shape[2] // 4
    if tuple(w_hh.shape) != (H, 4 * H):
        raise ValueError(f"w_hh must be ({H}, {4 * H}), got {tuple(w_hh.shape)}")
    for t in (h0, c0, *rows):
        if tuple(t.shape) != (B, H):
            raise ValueError(f"state tensors must be ({B}, {H}), got {tuple(t.shape)}")
    for t in (*seq, *fp32):
        if tuple(t.shape) not in ((S, B, H), (B, H)):
            raise ValueError(f"sequence tensors must be ({S}, {B}, {H}), got {tuple(t.shape)}")
    tensors = (xg, w_hh, h0, c0, *seq, *rows, *fp32)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"scan tensors lie on several devices: {devices}")
    device = xg.device
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"the LSTM scan kernel runs on CUDA or the CPU, not {device}")
    if xg.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16 xg, got {xg.dtype}")
    if any(t.dtype != xg.dtype for t in (*seq, *rows)):
        raise TypeError(f"ys, dys and dhT must have xg's dtype {xg.dtype}")
    if any(t.dtype != torch.float32 for t in (w_hh, h0, c0, *fp32)):
        raise TypeError("the kernel keeps w_hh, h0, c0, the cell states and dcT in float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if S * B * 4 * H >= 2**31:
        raise ValueError(f"S*B*4H = {S * B * 4 * H} is outside the kernel's range")
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lstm_scan_fwd(xg, w_hh, h0, c0):
    """xg (S, B, 4H), w_hh (H, 4H) fp32, h0 and c0 (B, H) fp32 -> (ys
    (S, B, H) in xg's dtype, cs (S, B, H) fp32)."""
    global SCAN_FWD_LAUNCHES
    if not _check(xg, w_hh, h0, c0):
        return ref.lstm_scan_ref(xg, w_hh, h0, c0)
    out = _launch_fwd(xg, w_hh, h0, c0)
    SCAN_FWD_LAUNCHES += 1
    return out


# the forward's phases, as its timed instantiation counts them
# (csrc/lstm_scan.cu, enum FwdPhase): the prologue (the weight slice) once
# a launch, the others each step
FWD_PHASES = ("prologue", "step operands", "barrier", "stage h", "gate dots", "cell update",
              "stores")


def lstm_scan_fwd_phases(xg, w_hh, h0, c0):
    """The forward on the card in its timed instantiation (a measurement:
    ``SCAN_FWD_LAUNCHES`` does not count it). Returns the outputs of
    ``lstm_scan_fwd``, its milliseconds (CUDA events) and an int64
    (blocks, S + 1, len(FWD_PHASES)) table of the nanoseconds thread 0 of
    each block spent in each phase: row t for step t, row S for the
    prologue."""
    if not _check(xg, w_hh, h0, c0):
        raise ValueError("the forward's phase timer runs on the card only")
    S, H = xg.shape[0], xg.shape[2] // 4
    blocks = -(-H // _units_per_block(xg.device.index or 0, H))
    times = torch.zeros((blocks, S + 1, len(FWD_PHASES)), dtype=torch.int64, device=xg.device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    out = _launch_fwd(xg, w_hh, h0, c0, times)
    events[1].record()
    events[1].synchronize()
    return out, events[0].elapsed_time(events[1]), times


def _launch_fwd(xg, w_hh, h0, c0, times=None):
    """The forward kernel: (ys, cs)."""
    S, B, H4 = xg.shape
    H = H4 // 4
    U = _units_per_block(xg.device.index or 0, H)
    ys = torch.empty((S, B, H), dtype=xg.dtype, device=xg.device)
    cs = torch.empty((S, B, H), dtype=torch.float32, device=xg.device)
    hbuf = torch.empty((2, B, H), dtype=torch.float32, device=xg.device)
    _launch(_lib().lstm_scan_fwd(_DTYPE_CODES[xg.dtype], xg.data_ptr(), w_hh.data_ptr(),
                                 h0.data_ptr(), c0.data_ptr(), ys.data_ptr(), cs.data_ptr(),
                                 hbuf.data_ptr(), None if times is None else times.data_ptr(),
                                 S, B, H, U, _stream(xg)), "lstm_scan_fwd")
    return ys, cs


def lstm_scan_bwd_gates(xg, w_hh, h0, ys):
    """The backward's gate recompute alone: every step's gate activations
    [i|f|g|o] of ``xg + h_prev @ w_hh`` (S, B, 4H) fp32, h_prev being h0
    at t=0 and ys[t-1] after, as ``lstm_scan_bwd_rec`` computes them
    before its recurrence (two kernels on the card)."""
    global SCAN_BWD_GATES_LAUNCHES
    if not _check(xg, w_hh, h0, h0, seq=(ys,)):
        return ref.lstm_scan_bwd_gates_ref(xg, w_hh, h0, ys)
    acts = _launch_gates(xg, w_hh, h0, ys)
    SCAN_BWD_GATES_LAUNCHES += 1
    return acts


def lstm_scan_bwd_rec(xg, w_hh, h0, c0, ys, cs, dys, dhT, dcT):
    """The backward recurrence, t = S-1..0, from the saved (ys, cs):
    (dxg (S, B, 4H), dh0, dc0), fp32. ys, dys and dhT in xg's dtype. On
    the card, every step's gate recompute at once (as
    ``lstm_scan_bwd_gates``), then the recurrence over it, in place."""
    global SCAN_BWD_LAUNCHES
    if not _check(xg, w_hh, h0, c0, seq=(ys, dys), rows=(dhT,), fp32=(cs, dcT)):
        return ref.lstm_scan_bwd_rec_ref(xg, w_hh, h0, c0, ys, cs, dys, dhT, dcT)
    out = _launch_rec(lstm_scan_bwd_gates(xg, w_hh, h0, ys), w_hh, c0, cs, dys, dhT, dcT)
    SCAN_BWD_LAUNCHES += 1
    return out


# the backward recurrence's phases, as its timed instantiation counts them
# (csrc/lstm_scan.cu, enum Phase): the prologue (the weight slice) and the
# epilogue once a launch, the others each step
BWD_PHASES = ("prologue", "step operands", "stage shares", "cell update", "share product",
              "share stores", "barrier", "epilogue")


def lstm_scan_bwd_phases(xg, w_hh, h0, c0, ys, cs, dys, dhT, dcT):
    """The backward on the card with its recurrence's timed instantiation
    (a measurement: neither ``SCAN_BWD_GATES_LAUNCHES`` nor
    ``SCAN_BWD_LAUNCHES`` counts it). Returns
    the outputs of ``lstm_scan_bwd_rec``, the milliseconds of the gate
    recompute and of the recurrence (CUDA events), and an int64 (blocks,
    S + 1, len(BWD_PHASES)) table of the nanoseconds thread 0 of each
    block spent in each phase of the recurrence: row t for step t, row S
    for the prologue and the epilogue."""
    if not _check(xg, w_hh, h0, c0, seq=(ys, dys), rows=(dhT,), fp32=(cs, dcT)):
        raise ValueError("the backward's phase timer runs on the card only")
    S, H = xg.shape[0], xg.shape[2] // 4
    blocks = -(-H // _units_per_block(xg.device.index or 0, H))
    times = torch.zeros((blocks, S + 1, len(BWD_PHASES)), dtype=torch.int64, device=xg.device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    dxg = _launch_gates(xg, w_hh, h0, ys)
    events[1].record()
    out = _launch_rec(dxg, w_hh, c0, cs, dys, dhT, dcT, times)
    events[2].record()
    events[2].synchronize()
    return out, events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2]), times


def _launch_gates(xg, w_hh, h0, ys):
    """The gate recompute's two kernels: the activations, into a new
    (S, B, 4H) fp32 tensor."""
    S, B, H4 = xg.shape
    H = H4 // 4
    U = _units_per_block(xg.device.index or 0, H)
    lib = _lib()
    acts = torch.empty((S, B, H4), dtype=torch.float32, device=xg.device)
    # the products of the plan's KS slices of k, summed by the second kernel
    part = torch.empty(lib.lstm_scan_bwd_gates_floats(S, B, H, U), dtype=torch.float32,
                       device=xg.device)
    _launch(lib.lstm_scan_bwd_gates(_DTYPE_CODES[xg.dtype], xg.data_ptr(), h0.data_ptr(),
                                    ys.data_ptr(), w_hh.data_ptr(), part.data_ptr(),
                                    acts.data_ptr(), S, B, H, U, _stream(xg)),
            "lstm_scan_bwd gates")
    return acts


def _launch_rec(dxg, w_hh, c0, cs, dys, dhT, dcT, times=None):
    """The recurrence over the activations in ``dxg``, which it overwrites
    with dgates: (dxg, dh0, dc0)."""
    S, B, H4 = dxg.shape
    H = H4 // 4
    U = _units_per_block(dxg.device.index or 0, H)
    lib = _lib()
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dxg.device)
    dc0 = torch.empty_like(dh0)
    # the exchange of dh shares between the blocks
    scratch = torch.empty(lib.lstm_scan_bwd_scratch_floats(S, B, H, U), dtype=torch.float32,
                          device=dxg.device)
    _launch(lib.lstm_scan_bwd(
        _DTYPE_CODES[dys.dtype], w_hh.data_ptr(), c0.data_ptr(), cs.data_ptr(), dys.data_ptr(),
        dhT.data_ptr(), dcT.data_ptr(), dxg.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        scratch.data_ptr(), None if times is None else times.data_ptr(), S, B, H, U,
        _stream(dxg)), "lstm_scan_bwd")
    return dxg, dh0, dc0


def _check_dw(h0, ys, dgates) -> bool:
    """True when the dw kernel must run (CUDA), False on the CPU."""
    if ys.dim() != 3 or tuple(dgates.shape) != (*ys.shape[:2], 4 * ys.shape[2]) \
            or tuple(h0.shape) != tuple(ys.shape[1:]):
        raise ValueError(f"h0 (B, H), ys (S, B, H) and dgates (S, B, 4H) disagree: "
                         f"{tuple(h0.shape)}, {tuple(ys.shape)}, {tuple(dgates.shape)}")
    devices = {t.device for t in (h0, ys, dgates)}
    if len(devices) != 1:
        raise ValueError(f"dw tensors lie on several devices: {devices}")
    if ys.device.type == "cpu":
        return False
    if ys.device.type != "cuda":
        raise ValueError(f"the LSTM scan kernel runs on CUDA or the CPU, not {ys.device}")
    if ys.dtype not in _DTYPE_CODES or h0.dtype != torch.float32 \
            or dgates.dtype != torch.float32:
        raise TypeError("the dw kernel takes ys in float32 or bfloat16, h0 and dgates in float32")
    if not all(t.is_contiguous() for t in (h0, ys, dgates)):
        raise ValueError("the kernel takes contiguous tensors")
    if dgates.numel() >= 2**31:
        raise ValueError(f"S*B*4H = {dgates.numel()} is outside the kernel's range")
    return True


def lstm_scan_dw(h0, ys, dgates):
    """dw_hh (H, 4H) fp32 = the sum over (t, b) of h_prevᵀ dgates, h_prev
    being h0 at t=0 and ys[t-1] after; h0 and dgates (S, B, 4H) fp32."""
    global SCAN_DW_LAUNCHES
    if not _check_dw(h0, ys, dgates):
        return ref.lstm_scan_dw_ref(h0, ys, dgates)
    S, B, H = ys.shape
    dw = torch.empty((H, 4 * H), dtype=torch.float32, device=ys.device)
    _launch(_lib().lstm_scan_dw(_DTYPE_CODES[ys.dtype], h0.data_ptr(), ys.data_ptr(),
                                dgates.data_ptr(), dw.data_ptr(), S, B, H, _stream(ys)),
            "lstm_scan_dw")
    SCAN_DW_LAUNCHES += 1
    return dw


DW_TILE = (64, 128)  # the dw kernel's tile of (H, 4H), one block of 128 threads each


def dw_grid(H: int) -> int:
    """Blocks of one dw launch at width H."""
    return -(-H // DW_TILE[0]) * -(-4 * H // DW_TILE[1])


def dw_blocks_per_sm(dtype: torch.dtype, vec: bool = True) -> int:
    """How many dw blocks an SM of the current card holds at once (the
    16-byte route with ``vec``, else the element-wise one)."""
    blocks = _I(0)
    build.check_launch(_lib().lstm_scan_dw_blocks_per_sm(_DTYPE_CODES[dtype], int(vec),
                                                         ctypes.byref(blocks)),
                       "lstm_scan_dw occupancy")
    return blocks.value


class LSTMScanFn(torch.autograd.Function):
    """The recurrence with its fused backward, as ``_lstm_scan_vjp``
    (``repro/kernels/lstm_gates.py:346-366``): returns (ys, ys[-1],
    cs[-1]) and saves (xg, w_hh, h0, c0, ys, cs); the backward recomputes
    the gates. Gradients come back in each input's dtype."""

    @staticmethod
    def forward(ctx, xg, w_hh, h0, c0):
        ys, cs = lstm_scan_fwd(xg, w_hh, h0, c0)
        ctx.save_for_backward(xg, w_hh, h0, c0, ys, cs)
        # hT and cT are copies: a Function's outputs must not be views
        # of one another
        return ys, ys[-1].clone(), cs[-1].clone()

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        xg, w_hh, h0, c0, ys, cs = ctx.saved_tensors
        dxg, dh0, dc0 = lstm_scan_bwd_rec(
            xg, w_hh, h0, c0, ys, cs, dys.to(xg.dtype).contiguous(),
            dhT.to(xg.dtype).contiguous(), dcT.to(cs.dtype).contiguous())
        dw = lstm_scan_dw(h0, ys, dxg)
        return dxg.to(xg.dtype), dw.to(w_hh.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype)


def lstm_scan_fused_vjp(xg, w_hh, h0, c0):
    """The training-path entry point: (ys (S, B, H), h_final, c_final),
    differentiable in all four inputs. The input product ``xs @ w_ih + b``
    stays outside, under ordinary autograd."""
    return LSTMScanFn.apply(xg, w_hh, h0, c0)
