"""The attention kernel (K10) and its backward: wrapper, route and launch
counts.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:70
flash_attention`` and stands behind the port's ``blockwise_attention``
(``models/attention.py``), which the model calls. The forward kernels
are CUDA C++ in ``csrc/attention.cu``, the backward's in
``csrc/attention_bwd_wgmma.cu`` and ``csrc/attention_bwd.cu`` (each
header states what bounds it on the card), built by ``build.py`` and
called through ctypes. They take the
scale and the query offset of ``repro/models/attention.py:84
blockwise_attention`` and mask ragged tiles, so every call of the
model's function on the card runs them.

Every route takes a q·k width D up to ``MAX_QK_DIM`` = 256 and a v width
Dv up to ``MAX_V_DIM`` = 256: gemma3's heads of 256
(``repro/configs/gemma3_4b.py``) and multi-head latent attention's 128 +
64 against 128 (``repro/models/mla.py:73``) at their full widths. Two
forward routes, chosen by a fixed rule (``route``), not by a fallback: bf16
q, k and v with D and Dv multiples of 16, 16-byte aligned, go to the
tensor-core kernel (``flash_attention_wgmma``; two warpgroups a block past
Dv = 128, each accumulating half of the output's columns); everything else
(fp32, other widths) to the CUDA-core kernel (``flash_attention``). A
failed build or launch raises. On the card, a call that autograd must
differentiate (grad mode on and an input that requires grad: ``grad_path``)
runs through ``K10Function``: its forward launches K10 with the rows'
log-sum-exp, its backward the backward kernel (``flash_attention_bwd``);
any other call launches the forward alone. The wrapper takes the plain
version (``ref.flash_attention_ref``, differentiable by autograd) only
for tensors on the CPU. ``FWD_LAUNCHES`` counts every forward launch,
``WGMMA_LAUNCHES`` and ``SIMT_LAUNCHES`` those of each route, and
``WGMMA_WIDE_LAUNCHES`` and ``SIMT_WIDE_LAUNCHES`` those of each route on
the instantiations for heads past 192 and 128 that gemma3's heads of 256
take (the two warpgroups a block at Dv > 128, the CUDA-core tiles of 256):
the library's ``*_wide`` entries say which launches those are, by the
tests its dispatch branches on.

The backward has two routes by the same kind of fixed rule
(``bwd_route``): bf16 with D and Dv multiples of 16 and every tensor
contiguous and 16-byte aligned goes to the tensor-core design
(``csrc/attention_bwd_wgmma.cu``: TMA-fed wgmma products, P and dS kept
fp32 as two bf16 terms, one warpgroup a block of 64 keys for dK and dV,
of 64 query rows for dQ; past a width of 128 two warpgroups a block for
dK and dV, one accumulating each; past 192 each output's columns in two
halves over the grid); everything else (fp32, other widths) to the CUDA-core
design (``csrc/attention_bwd.cu``). Each is three launches a call (the
rows' di, dK/dV, dQ), sums in one fixed order, no atomics.
``BWD_LAUNCHES`` counts the backward's calls, ``BWD_WGMMA_LAUNCHES`` and
``BWD_SIMT_LAUNCHES`` those of each route, ``BWD_WGMMA_WIDE_LAUNCHES`` and
``BWD_SIMT_WIDE_LAUNCHES`` those on the column halves (ND or NV = 4) and the
CUDA-core tiles of 256, by the libraries' ``*_wide`` entries.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

FWD_LAUNCHES = 0
WGMMA_LAUNCHES = 0
SIMT_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_WGMMA_LAUNCHES = 0
BWD_SIMT_LAUNCHES = 0
WGMMA_WIDE_LAUNCHES = 0
SIMT_WIDE_LAUNCHES = 0
BWD_WGMMA_WIDE_LAUNCHES = 0
BWD_SIMT_WIDE_LAUNCHES = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_QK_DIM = 256  # D, the q·k width
MAX_V_DIM = 256   # Dv
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("attention")
    lib.flash_attention_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                        _F, _I, _I, _F, _I, _P]
    lib.flash_attention_fwd.restype = _I
    lib.flash_attention_wgmma_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                              _F, _I, _I, _F, _I, _P]
    lib.flash_attention_wgmma_fwd.restype = _I
    lib.flash_decode_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _F, _I, _I, _F, _I, _P]
    lib.flash_decode_fwd.restype = _I
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("attention_bwd")
    lib.flash_attention_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _I, _P]
    lib.flash_attention_bwd.restype = _I
    return lib


@functools.cache
def _bwd_wgmma_lib() -> ctypes.CDLL:
    lib = build.load("attention_bwd_wgmma")
    lib.flash_attention_bwd_wgmma.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                              _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _I, _P]
    lib.flash_attention_bwd_wgmma.restype = _I
    return lib


def check_devices(what: str, *tensors) -> bool:
    """True when the tensors lie on one CUDA device (the kernel runs),
    False when on the CPU (the plain version); raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {device}")
    return True


def check_kernel_inputs(what: str, *tensors) -> None:
    """The kernels' contract: one dtype of fp32 or bf16, contiguous."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= DTYPE_CODES.keys():
        raise TypeError(f"{what}: the kernel takes one dtype of float32 or bfloat16, "
                        f"got {sorted(map(str, dtypes))}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: the kernel takes contiguous tensors")


def grad_path(*tensors) -> bool:
    """True when a call on the card must run through ``K10Function`` (the
    forward with its log-sum-exp, then the backward kernel): grad mode is
    on and an input requires grad, so autograd will differentiate it
    (``repro/models/attention.py:blockwise_attention`` is differentiable
    under ``jax.grad``). Otherwise the forward runs alone."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a launch on the card takes: "wgmma" (tensor cores) for
    bf16 with D and Dv multiples of 16 and 16-byte aligned tensors, else
    "simt" (CUDA cores)."""
    D, Dv = q.shape[-1], v.shape[-1]
    if (q.dtype == torch.bfloat16 and D % 16 == 0 and Dv % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return "wgmma"
    return "simt"


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
              do: torch.Tensor) -> str:
    """The backward a call on the card takes: "wgmma" (tensor cores) for
    bf16 with D and Dv multiples of 16 and q, k, v, o and do contiguous
    and 16-byte aligned, else "simt" (CUDA cores)."""
    D, Dv = q.shape[-1], v.shape[-1]
    tensors = (q, k, v, o, do)
    if (all(t.dtype == torch.bfloat16 for t in tensors) and D % 16 == 0 and Dv % 16 == 0
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors)):
        return "wgmma"
    return "simt"


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    Sk, Kv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if (k.shape[0], k.shape[3]) != (B, D) or tuple(v.shape[:3]) != (B, Sk, Kv) or H % Kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "do not agree (H must be a multiple of Kv)")


def _check_kernel_shapes(q, k, v):
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    if D > MAX_QK_DIM or Dv > MAX_V_DIM:
        raise ValueError(f"the kernel takes a q.k width D up to {MAX_QK_DIM} and a v width Dv "
                         f"up to {MAX_V_DIM}, got D={D} and Dv={Dv}")
    if Sq == 0 or Sk == 0 or B * H > 65535:
        raise ValueError(f"the kernel takes Sq, Sk >= 1 and B*H <= 65535; got Sq={Sq}, "
                         f"Sk={Sk}, B*H={B * H}")


def _forward(q, k, v, causal, window, logit_softcap, q_offset, scale, with_lse: bool):
    """One launch of K10 on the card: o (B, Sq, H, Dv) in q's dtype, and
    with ``with_lse`` the rows' log-sum-exp (B, H, Sq) fp32 (else None)."""
    global FWD_LAUNCHES, WGMMA_LAUNCHES, SIMT_LAUNCHES, WGMMA_WIDE_LAUNCHES, SIMT_WIDE_LAUNCHES
    B, Sq, H, D = q.shape
    Sk, Kv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (B, Sq, Sk, H, Kv, D, Dv, scale, int(bool(causal)), int(window or 0),
            float(logit_softcap), int(q_offset), stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None)
    if route(q, k, v) == "wgmma":
        build.check_launch(_lib().flash_attention_wgmma_fwd(*ptrs, *args),
                           "flash_attention_wgmma_fwd")
        WGMMA_LAUNCHES += 1
        WGMMA_WIDE_LAUNCHES += _lib().flash_attention_wgmma_wide(D, Dv)
    else:
        build.check_launch(_lib().flash_attention_fwd(DTYPE_CODES[q.dtype], *ptrs, *args),
                           "flash_attention_fwd")
        SIMT_LAUNCHES += 1
        SIMT_WIDE_LAUNCHES += _lib().flash_attention_simt_wide(D, Dv)
    FWD_LAUNCHES += 1
    return o, lse


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True, window=None,
                            logit_softcap: float = 0.0, q_offset: int = 0, scale=None):
    """(o, lse): the forward and its rows' log-sum-exp (B, H, Sq) fp32,
    +inf for a row with no valid key. One K10 launch on the card, the
    plain version (``ref.flash_attention_ref``) on the CPU."""
    _check_shapes(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if not check_devices("flash_attention", q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       logit_softcap=logit_softcap, q_offset=q_offset,
                                       scale=scale, return_lse=True)
    check_kernel_inputs("flash_attention", q, k, v)
    _check_kernel_shapes(q, k, v)
    return _forward(q, k, v, causal, window, logit_softcap, q_offset, scale, True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window=None,
                        logit_softcap: float = 0.0, q_offset: int = 0, scale=None):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) from its output
    ``o``, its log-sum-exp ``lse`` and the output's cotangent ``do``, each
    in its input's dtype. One call of the backward on the card (three
    launches) on the route ``bwd_route`` picks, ``ref.flash_attention_bwd_ref``
    on the CPU."""
    global BWD_LAUNCHES, BWD_WGMMA_LAUNCHES, BWD_SIMT_LAUNCHES
    global BWD_WGMMA_WIDE_LAUNCHES, BWD_SIMT_WIDE_LAUNCHES
    _check_shapes(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if not check_devices("flash_attention_bwd", q, k, v, o, lse, do):
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                           logit_softcap=logit_softcap, q_offset=q_offset,
                                           scale=scale)
    check_kernel_inputs("flash_attention_bwd", q, k, v, o, do)
    _check_kernel_shapes(q, k, v)
    B, Sq, H, D = q.shape
    Sk, Kv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq) or not lse.is_contiguous()
            or tuple(o.shape) != (B, Sq, H, Dv) or tuple(do.shape) != (B, Sq, H, Dv)):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do {tuple(do.shape)} and "
                         f"lse {tuple(lse.shape)} {lse.dtype} do not fit q, k and v")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    args = (B, Sq, Sk, H, Kv, D, Dv, scale, int(bool(causal)), int(window or 0),
            float(logit_softcap), int(q_offset), stream)
    if bwd_route(q, k, v, o, do) == "wgmma":
        # the rows' lse log2(e) and di, each padded to whole tiles of 64 rows
        scratch = torch.empty(2 * B * H * -(-Sq // 64) * 64, dtype=torch.float32,
                              device=q.device)
        build.check_launch(_bwd_wgmma_lib().flash_attention_bwd_wgmma(
            *ptrs, scratch.data_ptr(), *args), "flash_attention_bwd_wgmma")
        BWD_WGMMA_LAUNCHES += 1
        BWD_WGMMA_WIDE_LAUNCHES += _bwd_wgmma_lib().flash_attention_bwd_wgmma_wide(D, Dv)
    else:
        di = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        build.check_launch(_bwd_lib().flash_attention_bwd(
            DTYPE_CODES[q.dtype], *ptrs, di.data_ptr(), *args), "flash_attention_bwd")
        BWD_SIMT_LAUNCHES += 1
        BWD_SIMT_WIDE_LAUNCHES += _bwd_lib().flash_attention_bwd_simt_wide(D, Dv)
    BWD_LAUNCHES += 1
    return dq, dk, dv


class K10Function(torch.autograd.Function):
    """K10 under autograd on the card: the forward keeps (q, k, v, o, lse),
    the backward launches ``flash_attention_bwd`` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap, q_offset, scale):
        o, lse = _forward(q, k, v, causal, window, logit_softcap, q_offset, scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, logit_softcap=logit_softcap,
                        q_offset=q_offset, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window=None, logit_softcap: float = 0.0, q_offset: int = 0,
                    scale=None, block_kv: int = 512) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Sk, Kv, D), v (B, Sk, Kv, Dv) -> (B, Sq, H,
    Dv) in q's dtype. ``window`` None or 0 is no window; ``scale`` None is
    D**-0.5. ``block_kv`` is the plain version's kv block (the kernel's
    tile is its own). Differentiable on the card (``K10Function``) and on
    the CPU (the plain version under autograd)."""
    _check_shapes(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if not check_devices("flash_attention", q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       logit_softcap=logit_softcap, q_offset=q_offset,
                                       scale=scale, block_kv=block_kv)
    check_kernel_inputs("flash_attention", q, k, v)
    _check_kernel_shapes(q, k, v)
    if grad_path(q, k, v):
        return K10Function.apply(q, k, v, causal, window, logit_softcap, q_offset, scale)
    return _forward(q, k, v, causal, window, logit_softcap, q_offset, scale, False)[0]
