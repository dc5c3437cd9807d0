"""The decode attention kernel (K11): wrapper and launch count.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py:62
flash_decode`` and stands behind the port's ``decode_attention``
(``models/attention.py``). The kernel is CUDA C++ in ``csrc/attention.cu``
(its header states what bounds it), built by ``build.py`` and called
through ctypes. It reads ``pos`` from an int32 on the device, so a decode
step can be captured in a CUDA graph, and it takes the window, the ring
buffer, the softcap and the scale of ``repro/models/attention.py:158
decode_attention``. It splits the cache into ``SPLIT_SLOTS``-slot pieces,
one block each, whose partial softmaxes the last block of each (batch, kv
head) merges in split order: one launch, the same bits for the same
inputs. The split count depends on S only, so a captured launch replays
for any ``pos``.

It takes D and Dv up to ``MAX_HEAD_DIM`` = 256 (gemma3's heads): past
128 the kernel's queries and partial sums are sized for 256 columns.

The wrapper takes the plain version (``ref.decode_attention_ref``) only
for tensors on the CPU. A CUDA tensor gets the kernel or an exception;
nothing falls back. ``FWD_LAUNCHES`` counts the kernel's launches,
``WIDE_LAUNCHES`` those on its instantiation for 256 columns (the
library's ``flash_decode_wide``, the test its dispatch branches on).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import (
    DTYPE_CODES,
    _lib,
    check_devices,
    check_kernel_inputs,
)

FWD_LAUNCHES = 0
WIDE_LAUNCHES = 0
MAX_HEAD_DIM = 256  # D and Dv (the kernel's kMaxDim)
MAX_GROUP = 16  # query heads a kv head (the kernel's registers)
SPLIT_SLOTS = 64  # cache slots a block


def n_splits(S: int) -> int:
    """The kernel's splits of a cache of S slots (its grid's second axis)."""
    return -(-S // SPLIT_SLOTS)


def check_kernel_shapes(D: int, Dv: int, G: int, S: int) -> None:
    """The kernel's contract on widths, grouping and length."""
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM or G > MAX_GROUP or S == 0:
        raise ValueError(f"the kernel takes D, Dv <= {MAX_HEAD_DIM}, H/Kv <= {MAX_GROUP} and "
                         f"S >= 1; got D={D}, Dv={Dv}, H/Kv={G}, S={S}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos, *,
                 window=None, ring: bool = False, logit_softcap: float = 0.0,
                 scale=None) -> torch.Tensor:
    """q (B, H, D), caches (B, S, Kv, D / Dv), pos (an int or a 0-d
    integer tensor: the current token, already written) -> (B, H, Dv) in
    q's dtype. ``window`` None or 0 is no window; ``scale`` None is
    D**-0.5."""
    global FWD_LAUNCHES, WIDE_LAUNCHES
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("q must be (B, H, D) and the caches (B, S, Kv, D)")
    B, H, D = q.shape
    S, Kv, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    if (k_cache.shape[0], k_cache.shape[3]) != (B, D) or \
            tuple(v_cache.shape[:3]) != (B, S, Kv) or H % Kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)} do not agree (H a multiple of Kv)")
    scale = D ** -0.5 if scale is None else float(scale)
    pos_t = pos if isinstance(pos, torch.Tensor) else None
    on_card = check_devices("flash_decode", q, k_cache, v_cache,
                            *(() if pos_t is None else (pos_t,)))
    if not on_card:
        return ref.decode_attention_ref(q, k_cache, v_cache, pos, window=window, ring=ring,
                                        logit_softcap=logit_softcap, scale=scale)
    check_kernel_inputs("flash_decode", q, k_cache, v_cache)
    G = H // Kv
    check_kernel_shapes(D, Dv, G, S)
    if pos_t is None:
        pos_t = torch.full((), pos, dtype=torch.int32, device=q.device)
    elif pos_t.numel() != 1 or pos_t.dtype != torch.int32:
        raise TypeError(f"pos must be one int32 on the device, got {pos_t.dtype} "
                        f"{tuple(pos_t.shape)}")
    o = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    # each split's partial (m, l, acc[Dv]) for each query row, and a ticket
    # per (batch, kv head), 0 before the launch
    part = torch.empty((B * H * n_splits(S) * (Dv + 2),), dtype=torch.float32, device=q.device)
    tickets = torch.zeros((B * Kv,), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check_launch(
        _lib().flash_decode_fwd(DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
                                v_cache.data_ptr(), o.data_ptr(), pos_t.data_ptr(),
                                part.data_ptr(), tickets.data_ptr(), B, S, Kv, G, D, Dv, scale,
                                int(window or 0), int(bool(ring)), float(logit_softcap),
                                SPLIT_SLOTS, stream),
        "flash_decode_fwd",
    )
    FWD_LAUNCHES += 1
    WIDE_LAUNCHES += _lib().flash_decode_wide(D, Dv)
    return o
