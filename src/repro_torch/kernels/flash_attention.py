"""The forward attention kernel (K10): wrapper, route and launch counts.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:70
flash_attention`` and stands behind the port's ``blockwise_attention``
(``models/attention.py``), which the model calls. The kernels are CUDA
C++ in ``csrc/attention.cu`` (its header states what bounds each on the
card), built by ``build.py`` and called through ctypes. They take the
scale and the query offset of ``repro/models/attention.py:84
blockwise_attention`` and mask ragged tiles, so every call of the
model's function on the card runs one of them.

Two routes, chosen by a fixed rule (``route``), not by a fallback: bf16
q, k and v with D and Dv multiples of 16, 16-byte aligned, go to the
tensor-core kernel (``flash_attention_wgmma``); everything else (fp32,
other widths) to the CUDA-core kernel (``flash_attention``). A failed
build or launch raises. The wrapper takes the plain version
(``ref.flash_attention_ref``) only for tensors on the CPU, where it is
differentiable. The kernels have no backward: on the card a call that
autograd would have to differentiate raises (``refuses_grad``), rather
than return an output with no ``grad_fn``.
``FWD_LAUNCHES`` counts every launch, ``WGMMA_LAUNCHES`` and
``SIMT_LAUNCHES`` those of each route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

FWD_LAUNCHES = 0
WGMMA_LAUNCHES = 0
SIMT_LAUNCHES = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("attention")
    lib.flash_attention_fwd.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                        _F, _I, _I, _F, _I, _P]
    lib.flash_attention_fwd.restype = _I
    lib.flash_attention_wgmma_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                              _F, _I, _I, _F, _I, _P]
    lib.flash_attention_wgmma_fwd.restype = _I
    lib.flash_decode_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _F, _I, _I, _F, _I, _P]
    lib.flash_decode_fwd.restype = _I
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


def refuses_grad(*tensors) -> bool:
    """True when a call on the card must be refused: grad mode is on and
    an input requires grad, so autograd would need a backward the kernels
    do not have (``repro/models/attention.py:blockwise_attention`` is
    differentiable under ``jax.grad``)."""
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window=None, logit_softcap: float = 0.0, q_offset: int = 0,
                    scale=None, block_kv: int = 512) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Sk, Kv, D), v (B, Sk, Kv, Dv) -> (B, Sq, H,
    Dv) in q's dtype. ``window`` None or 0 is no window; ``scale`` None is
    D**-0.5. ``block_kv`` is the plain version's kv block (the kernel's
    tile is its own)."""
    global FWD_LAUNCHES, WGMMA_LAUNCHES, SIMT_LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    Sk, Kv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if (k.shape[0], k.shape[3]) != (B, D) or tuple(v.shape[:3]) != (B, Sk, Kv) or H % Kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "do not agree (H must be a multiple of Kv)")
    scale = D ** -0.5 if scale is None else float(scale)
    if not check_devices("flash_attention", q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       logit_softcap=logit_softcap, q_offset=q_offset,
                                       scale=scale, block_kv=block_kv)
    check_kernel_inputs("flash_attention", q, k, v)
    if refuses_grad(q, k, v):
        raise RuntimeError("flash_attention: the kernel has no backward; on the card call it "
                           "under torch.no_grad() or with inputs that do not require grad")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes D and Dv up to {MAX_HEAD_DIM}, got {D} and {Dv}")
    if Sq == 0 or Sk == 0 or B * H > 65535:
        raise ValueError(f"the kernel takes Sq, Sk >= 1 and B*H <= 65535; got Sq={Sq}, "
                         f"Sk={Sk}, B*H={B * H}")
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (B, Sq, Sk, H, Kv, D, Dv, scale, int(bool(causal)), int(window or 0),
            float(logit_softcap), int(q_offset), stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if route(q, k, v) == "wgmma":
        build.check_launch(_lib().flash_attention_wgmma_fwd(*ptrs, *args),
                           "flash_attention_wgmma_fwd")
        WGMMA_LAUNCHES += 1
    else:
        build.check_launch(_lib().flash_attention_fwd(DTYPE_CODES[q.dtype], *ptrs, *args),
                           "flash_attention_fwd")
        SIMT_LAUNCHES += 1
    FWD_LAUNCHES += 1
    return o
