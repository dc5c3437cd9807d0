"""The compression plane's kernels (K5-K9): wrappers over a client axis.

Replaces the Pallas TPU kernels of ``repro/kernels/wire_pack.py``: the
keyed quantizers (K5, ``:286``, ``:310``), the streamed and nearest
quantizers (K6, ``:170``, ``:204``), the int4 nibble pack and unpack and
the dequantization (K7, ``:66``, ``:90``, ``:112``), the top-k scatter-add
(K8, ``:441``) and the top-k unpack (K9, ``:352`` and ``:387`` in one
call), with the public wrappers of ``:491-611``. K8 and K9 are two
launches a call each, the first shared: each client row's payload
bucketed by output window (``unpack_layout`` is its plain version). The
kernels are CUDA C++ in ``csrc/wire_pack.cu`` (its header states what
bounds them on the card), built by ``build.py`` and called through
ctypes.

Each wrapper takes a leading client axis: x (K, n), key words (K, 2), a
scale shared by the clients or one each (K,), so that one launch serves
all K clients of a leaf where the reference vmaps a one-client kernel. A
wrapper takes the plain version (``ref.py``) only for tensors on the CPU;
CUDA tensors get the kernel or an exception, and nothing falls back. ``QUANTIZE_LAUNCHES`` (K5 and K6,
one templated kernel), ``PACK_LAUNCHES``, ``UNPACK_LAUNCHES`` (K7) and
``DEQUANTIZE_LAUNCHES`` (K7), ``SCATTER_ADD_SORT_LAUNCHES`` and
``SCATTER_ADD_SUM_LAUNCHES`` (K8's two kernels; ``SCATTER_ADD_LAUNCHES``
counts its calls) and ``TOPK_UNPACK_LAUNCHES`` (K9's calls) count the
launches, so that a run can show that its compression went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

QUANTIZE_LAUNCHES = 0
PACK_LAUNCHES = 0
UNPACK_LAUNCHES = 0
SCATTER_ADD_LAUNCHES = 0
SCATTER_ADD_SORT_LAUNCHES = 0
SCATTER_ADD_SUM_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0
TOPK_UNPACK_LAUNCHES = 0

_NEAREST, _STREAMED, _KEYED = 0, 1, 2
SEGMENT = 2048  # K8's and K9's output window per block (kSeg in csrc/wire_pack.cu)
# K7's run edges, the sizes at which its kernels change path, for the
# checks that hold them to their plain versions: a thread takes 16 codes or
# wire bytes, so n around 16 and 32, odd (a row at a time, rows off the
# 16-byte grid) and even (flat runs across rows)
K7_RUN_EDGES = (15, 16, 17, 31, 32, 33)
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("wire_pack")
    lib.wire_quantize.argtypes = [_I, _I, _P, _P, _I, _P, _P, _P, _I, _I, ctypes.c_float, _P]
    lib.nibble_pack.argtypes = [_P, _P, _I, _I, _P]
    lib.nibble_unpack.argtypes = [_P, _P, _I, _I, _P]
    lib.dequantize.argtypes = [_P, _P, _I, _P, _I, _I, _P]
    lib.topk_scatter_add.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.topk_unpack.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    for fn in (lib.wire_quantize, lib.nibble_pack, lib.nibble_unpack, lib.dequantize,
               lib.topk_scatter_add, lib.topk_unpack):
        fn.restype = _I
    return lib


def _levels(bits: int) -> float:
    if bits not in (4, 8):
        raise ValueError(f"the wire codes are int4 or int8, got bits={bits}")
    return 2.0 ** (bits - 1) - 1.0


def _on_card(*tensors) -> bool:
    """True when the kernel must run (every tensor on one CUDA device),
    False for the plain version (every tensor on the CPU); raises on
    anything else."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"the wire tensors lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"the wire kernels run on CUDA or the CPU, not {device}")
    return True


def _check_rows(x: torch.Tensor, dtype: torch.dtype, what: str) -> tuple[int, int]:
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{what} must be (K, n) with K, n >= 1, got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {x.dtype}")
    K, n = x.shape
    if K > 65535 or n >= 2**31 - 1:
        raise ValueError(f"{what} of shape {tuple(x.shape)} is outside the kernels' range "
                         "(K <= 65535, n < 2**31 - 1)")
    return K, n


def _scale_tensor(scale, K: int, like: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The scale on like's device and its stride over the clients: one
    value shared by the K clients (stride 0), or (K,) one each (stride 1)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=like.device)
    if s.dim() == 0 or tuple(s.shape) == (1,):
        return s.reshape(()), 0
    if tuple(s.shape) != (K,):
        raise ValueError(f"the scale is one fp32 value shared by the clients or one for "
                         f"each of the {K} clients, got {tuple(s.shape)}")
    return s.contiguous(), 1


def _key_words_u32(key_data: torch.Tensor, K: int, device) -> torch.Tensor:
    """(K, 2) key words in [0, 2**32) -> their bits as int32 on ``device``,
    which the kernel reads as uint32."""
    if tuple(key_data.shape) != (K, 2):
        raise ValueError(f"key_data must be ({K}, 2), got {tuple(key_data.shape)}")
    kd = key_data.to(device=device, dtype=torch.int64)
    return torch.where(kd >= 2**31, kd - 2**32, kd).to(torch.int32).contiguous()


def _quantize(x, scale, u, key_data, bits: int, pack4: bool):
    """The kernel path of every quantizer: (K, n) fp32 -> (K, n) int8
    codes or (K, (n+1)//2) int8 nibble bytes."""
    global QUANTIZE_LAUNCHES
    K, n = _check_rows(x, torch.float32, "x")
    mode = _NEAREST if u is None and key_data is None else (_KEYED if u is None else _STREAMED)
    if u is not None and (u.shape != x.shape or u.dtype != torch.float32):
        raise ValueError(f"u must be fp32 of x's shape {tuple(x.shape)}")
    x = x.contiguous()
    s, s_stride = _scale_tensor(scale, K, x)
    u = None if u is None else u.contiguous()
    keys = None if key_data is None else _key_words_u32(key_data, K, x.device)
    out = torch.empty((K, (n + 1) // 2 if pack4 else n), dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check_launch(
        _lib().wire_quantize(mode, int(pack4), x.data_ptr(), s.data_ptr(), s_stride,
                             None if u is None else u.data_ptr(),
                             None if keys is None else keys.data_ptr(), out.data_ptr(), K, n,
                             _levels(bits), stream),
        "wire_quantize",
    )
    QUANTIZE_LAUNCHES += 1
    return out


def quantize_with_scale(x, scale, u, bits: int):
    """x (K, n) fp32, one scale for all clients or (K,) one each, uniforms u (K, n) fp32
    (None: round to nearest, half to even) -> (K, n) int8 codes in
    [-levels, levels] (K6)."""
    if not _on_card(x, u):
        return ref.quantize_codes_with_scale_ref(x, scale, u, _levels(bits))
    return _quantize(x, scale, u, None, bits, pack4=False)


def quantize_pack(x, scale, u, bits: int):
    """The intN wire buffer of each client: the codes (int8), or their
    nibble-packed bytes (K, (n+1)//2) (int4), quantized in one pass (K6)."""
    if not _on_card(x, u):
        return ref.quantize_pack_ref(x, scale, u, bits)
    return _quantize(x, scale, u, None, bits, pack4=bits == 4)


def quantize_with_scale_keyed(x, scale, key_data, bits: int):
    """Keyed twin of ``quantize_with_scale`` (K5): client k's uniforms are
    the threefry draw ``jax.random.uniform(key_k, (n,))`` made from its
    key words key_data[k] and each element's position, never stored."""
    if not _on_card(x):
        u = ref.threefry_uniform_ref(key_data.to(x.device), x.shape[-1])
        return ref.quantize_codes_with_scale_ref(x, scale, u, _levels(bits))
    return _quantize(x, scale, None, key_data, bits, pack4=False)


def quantize_pack_keyed(x, scale, key_data, bits: int):
    """Keyed twin of ``quantize_pack`` (K5): quantize, round against the
    in-kernel draw and (int4) nibble-pack in one pass."""
    if not _on_card(x):
        u = ref.threefry_uniform_ref(key_data.to(x.device), x.shape[-1])
        return ref.quantize_pack_ref(x, scale, u, bits)
    return _quantize(x, scale, None, key_data, bits, pack4=bits == 4)


def nibble_pack(codes):
    """codes (K, n) int8 in [-8, 7] -> (K, (n+1)//2) int8 wire bytes (K7)."""
    global PACK_LAUNCHES
    if not _on_card(codes):
        return ref.nibble_pack_ref(codes)
    K, n = _check_rows(codes, torch.int8, "codes")
    codes = codes.contiguous()
    out = torch.empty((K, (n + 1) // 2), dtype=torch.int8, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    build.check_launch(_lib().nibble_pack(codes.data_ptr(), out.data_ptr(), K, n, stream),
                       "nibble_pack")
    PACK_LAUNCHES += 1
    return out


def nibble_unpack(packed, n: int):
    """packed (K, (n+1)//2) int8 -> (K, n) int8 sign-extended codes (K7)."""
    global UNPACK_LAUNCHES
    if not _on_card(packed):
        return ref.nibble_unpack_ref(packed, n)
    K, nb = _check_rows(packed, torch.int8, "packed")
    if nb != (n + 1) // 2:
        raise ValueError(f"{nb} packed bytes cannot hold n={n} codes")
    packed = packed.contiguous()
    out = torch.empty((K, n), dtype=torch.int8, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    build.check_launch(_lib().nibble_unpack(packed.data_ptr(), out.data_ptr(), K, n, stream),
                       "nibble_unpack")
    UNPACK_LAUNCHES += 1
    return out


def topk_scatter_add(values, idx, weights, n: int):
    """Stacked top-k payloads -> their weighted sum: values (K, k) fp32,
    idx (K, k) int flat indices, distinct within a row, weights (K,) ->
    dense (n,) fp32; an index several clients picked sums in client order
    from 0; indices outside [0, n) are dropped (K8). On the card one call
    launches two kernels (each row bucketed by window, then one block a
    window adds the rows in client order); no host sync."""
    global SCATTER_ADD_LAUNCHES, SCATTER_ADD_SORT_LAUNCHES, SCATTER_ADD_SUM_LAUNCHES
    if not _on_card(values, idx, weights):
        return ref.topk_scatter_add_ref(values, idx, weights, n)
    K, k = _check_rows(values, torch.float32, "values")
    if idx.shape != values.shape or weights.shape != (K,):
        raise ValueError(f"idx must be {tuple(values.shape)} and weights ({K},), got "
                         f"{tuple(idx.shape)}, {tuple(weights.shape)}")
    values, idx = _topk_operands(values, idx, n)
    weights = weights.to(torch.float32).contiguous()
    scratch = torch.empty(_scratch_parts(K, k, n)[1], dtype=torch.int32, device=values.device)
    out = torch.empty(n, dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    build.check_launch(
        _lib().topk_scatter_add(values.data_ptr(), idx.data_ptr(), weights.data_ptr(),
                                scratch.data_ptr(), out.data_ptr(), K, k, n, SEGMENT, stream),
        "topk_scatter_add",
    )
    SCATTER_ADD_SORT_LAUNCHES += 1
    SCATTER_ADD_SUM_LAUNCHES += 1
    SCATTER_ADD_LAUNCHES += 1
    return out


def dequantize(codes, scale):
    """codes (K, n) int8 times the scale, one for all clients or (K,) one
    each -> (K, n) fp32 (K7)."""
    global DEQUANTIZE_LAUNCHES
    if not _on_card(codes):
        return ref.dequantize_ref(codes, scale)
    K, n = _check_rows(codes, torch.int8, "codes")
    codes = codes.contiguous()
    s, s_stride = _scale_tensor(scale, K, codes)
    out = torch.empty((K, n), dtype=torch.float32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    build.check_launch(_lib().dequantize(codes.data_ptr(), s.data_ptr(), s_stride,
                                         out.data_ptr(), K, n, stream), "dequantize")
    DEQUANTIZE_LAUNCHES += 1
    return out


UNPACK_CHUNK = 8192  # K8's and K9's entries of a row sorted by one block (kChunk in csrc/wire_pack.cu)
# the sort's shared histogram holds a row of at most UNPACK_MAX_WINDOWS
# windows; a longer row is sorted by groups of UNPACK_GROUP_WINDOWS windows
# (kMaxWindows, kGroupWindows in csrc/wire_pack.cu)
UNPACK_MAX_WINDOWS = 36 * 1024
UNPACK_GROUP_WINDOWS = 32 * 1024


def unpack_layout(idx, n: int):
    """K8's and K9's layout, plain (the card builds it in
    ``csrc/wire_pack.cu``): each row of idx (K, k) cut into chunks of
    ``UNPACK_CHUNK`` entries, and each chunk's entries in [0, n) sorted by
    their ``SEGMENT``-wide output window. Returns (starts (K, nchunk, nseg
    + 1): the chunk's first slot of each window, the last column its count
    of entries in range; slots (K, k): each chunk's payload positions j in
    window order from the chunk's first position on, -1 past its count).
    Here a window's entries keep payload order; on the card their order is
    the atomics'. Indices outside [0, n) are in no window. A row of more
    than ``UNPACK_MAX_WINDOWS`` windows is sorted as the card sorts it, one
    group of ``UNPACK_GROUP_WINDOWS`` windows at a time, each group's run
    after the runs of the groups before: the same layout."""
    idx = idx.long()
    K, k = idx.shape
    nseg, nchunk = -(-n // SEGMENT), -(-k // UNPACK_CHUNK)
    width = nseg if nseg <= UNPACK_MAX_WINDOWS else UNPACK_GROUP_WINDOWS
    seg = torch.where((idx >= 0) & (idx < n), idx.div(SEGMENT, rounding_mode="floor"), nseg)
    starts = torch.zeros((K, nchunk, nseg + 1), dtype=torch.int64, device=idx.device)
    slots = torch.full((K, k), -1, dtype=torch.int64, device=idx.device)
    for b in range(nchunk):
        lo, hi = b * UNPACK_CHUNK, min(k, (b + 1) * UNPACK_CHUNK)
        part = seg[:, lo:hi]
        below = [0] * K  # each row's entries in the chunk's groups before
        for w_lo in range(0, nseg, width):
            w_hi = min(nseg, w_lo + width)
            mine = (part >= w_lo) & (part < w_hi)
            key = torch.where(mine, part, nseg)
            counts = torch.zeros((K, nseg + 1), dtype=torch.int64, device=idx.device)
            counts.scatter_add_(1, key, mine.long())
            starts[:, b, w_lo + 1:w_hi + 1] = (torch.tensor(below, device=idx.device)[:, None]
                                               + counts[:, w_lo:w_hi].cumsum(1))
            order = torch.sort(key, dim=1, stable=True).indices
            for r in range(K):
                m = int(mine[r].sum())
                slots[r, lo + below[r]:lo + below[r] + m] = order[r, :m] + lo
                below[r] += m
    return starts.int(), slots.int()


def _scratch_parts(K: int, k: int, n: int) -> tuple:
    """Where K8's and K9's layout lies in their int32 scratch
    (``TopkLayout`` in csrc/wire_pack.cu): (the keys' first int32, the
    total int32 count).
    The starts (K, nchunk, nseg + 1) come first, then the slots' 64-bit
    keys (K, k) on an 8-byte boundary, then their 16-bit window places."""
    nseg, nchunk = -(-n // SEGMENT), -(-k // UNPACK_CHUNK)
    key_at = (K * nchunk * (nseg + 1) + 1) // 2 * 2
    return key_at, key_at + 2 * K * k + (K * k + 1) // 2


def _topk_operands(values, idx, n: int):
    """K8's and K9's payload as their kernels take it, on the card: values
    (K, k) fp32 and idx (K, k) int32, contiguous. Raises outside the
    kernels' int32 range."""
    K, k = values.shape
    if n <= 0 or n >= 2**31 - SEGMENT or K * k >= 2**31 - 1:
        raise ValueError(f"n={n}, K*k={K * k} is outside the kernels' range (n < "
                         f"2**31 - {SEGMENT}, K*k < 2**31 - 1)")
    if idx.dtype != torch.int32:
        # an int64 index past int32's range must stay out of [0, n)
        idx = idx.clamp(-1, n).to(torch.int32)
    return values.contiguous(), idx.contiguous()


def _topk_unpack_kernels(values, idx, n: int):
    """Launch K9 on the card: (out (K, n), its int32 scratch)."""
    global TOPK_UNPACK_LAUNCHES
    K, k = _check_rows(values, torch.float32, "values")
    if idx.shape != values.shape:
        raise ValueError(f"idx must be {tuple(values.shape)}, got {tuple(idx.shape)}")
    values, idx = _topk_operands(values, idx, n)
    scratch = torch.empty(_scratch_parts(K, k, n)[1], dtype=torch.int32, device=values.device)
    out = torch.empty((K, n), dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    build.check_launch(
        _lib().topk_unpack(values.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
                           out.data_ptr(), K, k, n, SEGMENT, stream),
        "topk_unpack",
    )
    TOPK_UNPACK_LAUNCHES += 1
    return out, scratch


def kernel_layout(scratch, K: int, k: int, n: int):
    """The layout a K8 or K9 launch built, read from its scratch as
    ``unpack_layout`` gives it: (starts, slots), the slots being payload
    positions j in window order within each chunk, in the atomics' order
    inside a window, unspecified past the chunk's count."""
    nseg, nchunk = -(-n // SEGMENT), -(-k // UNPACK_CHUNK)
    key_at = _scratch_parts(K, k, n)[0]
    starts = scratch[:K * nchunk * (nseg + 1)].view(K, nchunk, nseg + 1)
    keys = scratch[key_at:key_at + 2 * K * k].view(torch.int64).view(K, k)
    high = (keys >> 32) & 0xFFFFFFFF  # the key's high word, unsigned
    order = high >> 11 if k < 2**21 else high  # the window place packed below j + 1, or not
    return starts, (order - 1).int()


def topk_unpack(values, idx, n: int):
    """Top-k payloads -> dense rows: values (K, k) fp32 at flat indices idx
    (K, k) -> (K, n) fp32, zero elsewhere; of pairs in a row that name one
    index, the last in payload order wins; indices outside [0, n) are
    dropped (K9). On the card one call launches two kernels (a sort of
    each chunk by window, by window group past ``UNPACK_MAX_WINDOWS``
    windows, then one block a window); no host sync."""
    if not _on_card(values, idx):
        return ref.topk_unpack_ref(values, idx, n)
    return _topk_unpack_kernels(values, idx, n)[0]
