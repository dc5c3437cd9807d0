"""The normal kernel: ``x + scale * jax.random.normal(key, x.shape)`` over
a table of tensors in one launch.

The reference draws FVN's weight noise (``repro/core/fvn.py:40-48``), the
gaussian adversary's (``repro/core/corruption.py:128-141``) and the DP
noise (``repro/core/aggregation.py:175-180``) leaf by leaf with
``jax.random.normal``, each leaf from its own key of ``split(key, L)``,
and adds it, scaled, to the leaf. ``normal_axpy`` does all the leaves of
such a call at once: the threefry words, XLA's float32 ``erf_inv`` and the
scaled sum in the kernel (CUDA C++ in ``csrc/threefry_normal.cu``, its
hash in ``csrc/threefry.cuh``), built by ``build.py`` on first use and
called through ctypes. Its plain version is ``ref.normal_axpy_ref``, and
the two give the same bits; both equal ``jax.random.normal`` on the CPU.

The wrapper takes the plain version only for tensors on the CPU. On CUDA
tensors it launches the kernel or raises: a failed build or launch is an
exception, and nothing falls back. One launch serves up to
``max_leaves()`` (64) tensors; ``NORMAL_LAUNCHES`` counts the launches.

``word_normals`` runs the kernel's normal over given 32-bit words (its own
launch, counted in ``WORDS_LAUNCHES``): a check that holds the device code
to ``ref.uniform_to_normal`` on every fill, which no path calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

NORMAL_LAUNCHES = 0
WORDS_LAUNCHES = 0

# leaf sizes at the kernel's run edges, for the checks that hold it to its
# plain version: a thread takes 4 threefry blocks (8 draws), a block 256
# threads, and a half's run of 4 is one 16-byte (fp32) or 8-byte (bf16)
# access where it is whole and aligned. n = 2·4 ± 1 and 256·4·2 ± 1, odd
# halves (6, 10, 4,094, 4,098), halves even but not a multiple of 4 (12,
# 16,388, 1,000,004: the high half's runs off the grid)
RUN_EDGES = (6, 7, 8, 9, 10, 12, 2_047, 2_048, 2_049, 4_094, 4_098, 16_388, 1_000_004)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Leaf(ctypes.Structure):
    """One entry of the kernel's table (``Leaf`` in csrc/threefry_normal.cu)."""

    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("scale_value", ctypes.c_float),
                ("n", ctypes.c_uint32), ("inner", ctypes.c_uint32),
                ("k0", ctypes.c_uint32), ("k1", ctypes.c_uint32),
                ("bf16", ctypes.c_int), ("first_block", ctypes.c_uint32)]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("threefry_normal")
    lib.threefry_normal_axpy.argtypes = [ctypes.POINTER(_Leaf), ctypes.c_int, ctypes.c_void_p]
    lib.threefry_normal_axpy.restype = ctypes.c_int
    lib.threefry_normal_max_leaves.restype = ctypes.c_int
    lib.threefry_normal_words.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p]
    lib.threefry_normal_words.restype = ctypes.c_int
    return lib


def max_leaves() -> int:
    """The tensors one launch serves (the kernel's table)."""
    return _lib().threefry_normal_max_leaves()


def _on_card(xs, scales) -> bool:
    """True when the kernel must run (every tensor on one CUDA device),
    False for the plain version (every tensor on the CPU); raises on
    anything else."""
    devices = {t.device for t in list(xs) + [s for s in scales if isinstance(s, torch.Tensor)]}
    if len(devices) != 1:
        raise ValueError(f"the normal kernel's tensors lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"the normal kernel runs on CUDA or the CPU, not {device}")
    return True


def _scale_entry(s, x: torch.Tensor):
    """(scale tensor or None, scale value, inner) of one leaf: a float is
    passed by value; a 0-dim or (1,) tensor is read from the device; a
    (K,) tensor scales each of K equal slices of the flattened leaf."""
    if not isinstance(s, torch.Tensor):
        return None, float(s), x.numel()
    s = s.to(torch.float32).contiguous()
    if s.numel() == 1:
        return s, 0.0, x.numel()
    if s.dim() != 1 or x.numel() % s.shape[0]:
        raise ValueError(f"a scale of shape {tuple(s.shape)} does not split a leaf of "
                         f"{x.numel()} elements into equal slices")
    return s, 0.0, x.numel() // s.shape[0]


def normal_axpy(xs, key_data: torch.Tensor, scales) -> list:
    """For each tensor x_i of ``xs`` (fp32 or bf16): (x_i.float() +
    scales[i] · jax.random.normal(key_i, x_i.shape)).to(x_i.dtype), with
    key_i the words key_data[i] (``key_data`` (L, 2) on the CPU, values in
    [0, 2**32)) and scales[i] a float, a 0-dim tensor, or a (K,) tensor
    whose entry k scales the k-th of K equal slices of the flattened
    x_i. Returns the new tensors in order."""
    global NORMAL_LAUNCHES
    xs, scales = list(xs), list(scales)
    if tuple(key_data.shape) != (len(xs), 2) or len(scales) != len(xs):
        raise ValueError(f"{len(xs)} tensors need key_data ({len(xs)}, 2) and {len(xs)} "
                         f"scales, got {tuple(key_data.shape)} and {len(scales)}")
    for x in xs:
        if x.dtype not in _DTYPES:
            raise TypeError(f"the normal kernel takes fp32 or bf16 tensors, got {x.dtype}")
        if x.numel() >= 2**31:
            raise ValueError(f"a tensor of {x.numel()} elements is outside the kernel's range "
                             "(< 2**31)")
    if not xs:
        return []
    if not _on_card(xs, scales):
        return ref.normal_axpy_ref(xs, key_data, scales)
    words = key_data.tolist()
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    table, held = [], []
    for x, out, (k0, k1), s in zip(xs, outs, words, scales):
        if x.numel() == 0:
            continue
        s_t, s_v, inner = _scale_entry(s, x)
        held.append(s_t)
        table.append(_Leaf(x.data_ptr(), out.data_ptr(), 0 if s_t is None else s_t.data_ptr(),
                           s_v, x.numel(), inner, k0, k1, _DTYPES[x.dtype], 0))
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    per = max_leaves()
    for start in range(0, len(table), per):
        part = table[start:start + per]
        build.check_launch(_lib().threefry_normal_axpy((_Leaf * len(part))(*part), len(part),
                                                       stream), "threefry_normal_axpy")
        NORMAL_LAUNCHES += 1
    return outs


def word_normals(words: torch.Tensor) -> torch.Tensor:
    """words (n,) int32 holding 32-bit threefry words -> (n,) float32,
    jax.random.normal's value of each word: the plain version
    (``ref.uniform_to_normal`` of the word's fill) on the CPU, the normal
    kernel's device code on CUDA."""
    global WORDS_LAUNCHES
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError(f"word_normals takes a 1-d int32 tensor, got {words.dtype} "
                        f"{tuple(words.shape)}")
    if words.device.type == "cpu":
        return ref.uniform_to_normal(ref.bits_to_uniform(words.to(torch.int64) & 0xFFFFFFFF))
    if words.device.type != "cuda":
        raise ValueError(f"word_normals runs on CUDA or the CPU, not {words.device}")
    words = words.contiguous()
    out = torch.empty(words.shape, dtype=torch.float32, device=words.device)
    if words.numel() == 0:
        return out
    stream = torch.cuda.current_stream(words.device).cuda_stream
    build.check_launch(_lib().threefry_normal_words(words.data_ptr(), out.data_ptr(),
                                                    words.numel(), stream),
                       "threefry_normal_words")
    WORDS_LAUNCHES += 1
    return out
