"""Uplink delta compression: the wire side of the CFMQ cost axis.

The port of ``repro/core/compression.py`` over the port's dicts of
tensors ({dotted name: tensor}):

- ``int8`` / ``int4``: per-tensor absmax quantization with stochastic
  (unbiased) or nearest rounding; a 4-byte fp32 scale rides along.
- ``topk``: per-tensor magnitude sparsification; ``k = ceil(frac *
  size)`` (value, index) pairs of 4 + 4 bytes travel.
- ``none``: fp32 on the wire (the paper's parity plane).

Byte accounting is pure Python over the tensors' sizes, so a template on
the ``meta`` device prices a model without allocating it.

Under the paper's weighted mean the round engine aggregates in the code
domain (``code_domain_aggregate``, ``code_domain_aggregate_ef``): the
clients' deltas arrive stacked per leaf, (K, ...); one scale per leaf is
negotiated by a max over the clients, every client quantizes against it
in one kernel launch per leaf (``kernels/wire_pack.py``), the int32 code
sum is exact and the server dequantizes once. Top-k payloads go through
one weighted scatter-add. The rounding keys fold the leaf's index in the
reference's tree order (``jax_leaf_order``), so the codes equal JAX's.

A robust aggregator or a delta adversary needs each client's dequantized
delta: the slow path compresses with ``make_compressor``, each client
against its own per-tensor scale, one kernel launch per leaf for all K
clients. With ``packed=False`` the codes are dequantized in PyTorch;
with ``packed=True`` the wire payload is materialized (``pack_leaf``: the
int8 codes, the int4 nibble bytes or the top-k pairs) and unpacked
(``unpack_leaf``: nibble unpack and dequantize, or the top-k unpack), and
the two give the same bits (``repro/core/compression.py:545-548``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import keys as keys_lib
from repro_torch.kernels import wire_pack

KINDS = ("none", "int8", "int4", "topk")

# fp32 scalar (scale) / value / index: all 4 bytes on the wire
_WORD = 4

_BITS = {"int8": 8, "int4": 4}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """The uplink compression of a plan."""

    kind: str = "none"  # none | int8 | int4 | topk
    topk_frac: float = 0.05  # fraction of coordinates kept per tensor
    stochastic: bool = True  # stochastic (unbiased) vs nearest rounding
    packed: bool = False  # the int4 codes travel nibble-packed
    error_feedback: bool = False  # EF21 per-client residual accumulation

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown compression kind {self.kind!r}; available: {KINDS}")
        # only the knob in use is checked, so an inert topk_frac (a CLI
        # default) may ride along with other kinds
        if self.kind == "topk" and not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], got {self.topk_frac}")
        if self.kind == "none" and self.packed:
            raise ValueError("packed=True materializes a quantized wire payload; "
                             "kind='none' ships raw fp32 and has nothing to pack")
        if self.kind == "none" and self.error_feedback:
            raise ValueError("error_feedback compensates compression error; with "
                             "kind='none' there is no error to feed back")


def _topk_count(frac: float, size: int) -> int:
    return max(1, min(size, int(math.ceil(frac * size))))


def leaf_wire_bytes(cfg: CompressionConfig, size: int) -> int:
    """Exact uplink bytes for one tensor of ``size`` elements."""
    if cfg.kind == "none":
        return _WORD * size
    if cfg.kind == "int8":
        return size + _WORD  # 1 B an element + the fp32 scale
    if cfg.kind == "int4":
        return (size + 1) // 2 + _WORD  # two elements a byte + the scale
    if cfg.kind == "topk":
        return 2 * _WORD * _topk_count(cfg.topk_frac, size)
    raise ValueError(cfg.kind)


def client_wire_bytes(cfg: CompressionConfig, params: dict) -> int:
    """Exact per-client uplink bytes for one delta."""
    return sum(leaf_wire_bytes(cfg, p.numel()) for p in params.values())


def tree_param_bytes(params: dict) -> int:
    """Downlink bytes: the server broadcasts the full model."""
    return sum(p.numel() * p.element_size() for p in params.values())


def wire_cost_profile(cfg: CompressionConfig, params: dict) -> dict:
    """Uplink bytes of one client delta under ``cfg``, the dense fp32
    bytes, and their ratio."""
    up = client_wire_bytes(cfg, params)
    dense = _WORD * sum(p.numel() for p in params.values())
    return {"kind": cfg.kind, "uplink_bytes": up, "dense_bytes": dense,
            "ratio": dense / up if up else float("inf")}


def jax_leaf_order(names) -> list:
    """Dotted parameter names in the order ``jax.tree_util.tree_flatten``
    gives the reference's nested tree: dict keys sorted as strings, list
    indices in numeric order (``encoder.2`` before ``encoder.10``). The
    fast path folds a leaf's index in this order into its rounding keys."""
    def key(name: str):
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split("."))

    return sorted(names, key=key)


# ----------------------------------------------------------------------
# Codes: tensors <-> the integers and (value, index) pairs a client sends.
# ----------------------------------------------------------------------


def _over_levels(m: torch.Tensor, bits: int) -> torch.Tensor:
    """m / levels as IEEE fp32 division, 1.0 where that is 0. The levels
    are a tensor on m's device: PyTorch's CUDA division by a Python
    number multiplies by its reciprocal, which can differ by an ulp."""
    levels = torch.tensor(2.0 ** (bits - 1) - 1.0, dtype=torch.float32, device=m.device)
    scale = m / levels
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def leaf_scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor absmax scale max|x| / levels, 1.0 for an all-zero tensor
    (its codes stay 0)."""
    return _over_levels(x.float().abs().max(), bits)


def quantize_codes_with_scale(x, key_data, scale, bits: int, stochastic: bool = True):
    """intN codes of one client's tensor x (any shape) against a given
    scale, stochastic rounding drawn from its key words (2,)."""
    xf = x.float().reshape(1, -1)
    if stochastic:
        codes = wire_pack.quantize_with_scale_keyed(xf, scale, key_data.reshape(1, 2), bits)
    else:
        codes = wire_pack.quantize_with_scale(xf, scale, None, bits)
    return codes.reshape(x.shape)


def quantize_codes(x, key_data, bits: int, stochastic: bool = True):
    """Per-tensor absmax intN codes of one client's tensor: (int8 codes
    shaped like x, fp32 scale)."""
    scale = leaf_scale(x, bits)
    return quantize_codes_with_scale(x, key_data, scale, bits, stochastic), scale


def dequantize_codes(codes, scale, dtype=torch.float32):
    """codes * scale; int8 codes are exact in fp32."""
    return (codes.float() * scale).to(dtype)


def topk_select(x: torch.Tensor, frac: float):
    """The top-k payload of each client row x (K, ...) (the reference's,
    vmapped): (fp32 values (K, k), int32 flat indices (K, k)),
    k = ceil(frac * n), by |x|."""
    flat = x.reshape(x.shape[0], -1).float()
    k = _topk_count(frac, flat.shape[1])
    idx = torch.topk(flat.abs(), k, dim=1).indices
    return torch.gather(flat, 1, idx), idx.to(torch.int32)


def client_leaf_scales(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``leaf_scale`` of each client's tensor in a client-stacked leaf x
    (K, ...): (K,) fp32."""
    return _over_levels(x.float().reshape(x.shape[0], -1).abs().amax(dim=1), bits)


def _quantize_leaf(x, kd, bits: int, stochastic: bool):
    """Each client's per-tensor absmax intN quantize then dequantize, x
    (K, ...) with the clients' leaf keys kd (K, 2)."""
    flat = x.float().reshape(x.shape[0], -1)
    scale = client_leaf_scales(flat, bits)
    codes = _quantize_payload(stochastic, flat, scale, kd, bits, pack=False)
    return dequantize_codes(codes, scale[:, None], x.dtype).reshape(x.shape)


def _topk_leaf(x, frac: float):
    """Each client's k largest-|x| coordinates kept, the rest zero, x (K, ...)."""
    vals, idx = topk_select(x, frac)
    flat = torch.zeros((x.shape[0], x[0].numel()), dtype=x.dtype, device=x.device)
    return flat.scatter_(1, idx.long(), vals.to(x.dtype)).reshape(x.shape)


# ----------------------------------------------------------------------
# Packed-wire payloads: the buffers behind the byte formulas.
# ----------------------------------------------------------------------


def pack_leaf(cfg: CompressionConfig, x: torch.Tensor, kd) -> tuple:
    """The uplink payloads of a client-stacked leaf x (K, ...), rounding
    with the clients' leaf keys kd (K, 2), as arrays with a leading client
    axis whose rows hold ``leaf_wire_bytes`` each:

    - int8: (int8 codes (K, n), fp32 scales (K,))         -> n + 4 a client
    - int4: (int8 nibble bytes (K, (n+1)//2), scales (K,)) -> (n+1)//2 + 4
    - topk: (fp32 values (K, k), int32 indices (K, k))     -> 8k
    """
    if cfg.kind == "topk":
        return topk_select(x, cfg.topk_frac)
    bits = _BITS[cfg.kind]
    flat = x.float().reshape(x.shape[0], -1)
    scale = client_leaf_scales(flat, bits)
    return _quantize_payload(cfg.stochastic, flat, scale, kd, bits, pack=True), scale


def unpack_leaf(cfg: CompressionConfig, payload: tuple, shape, dtype=torch.float32):
    """The reverse of ``pack_leaf``: the payloads -> the dequantized leaf of
    ``shape`` (K, ...). Equal bit for bit to ``_quantize_leaf`` and
    ``_topk_leaf`` on the same leaf (the same codes, one product each)."""
    size = math.prod(shape[1:])
    if cfg.kind == "topk":
        vals, idx = payload
        return wire_pack.topk_unpack(vals, idx, size).reshape(shape).to(dtype)
    data, scale = payload
    codes = wire_pack.nibble_unpack(data, size) if cfg.kind == "int4" else data
    return wire_pack.dequantize(codes, scale).reshape(shape).to(dtype)


def packed_leaf_bytes(payload: tuple) -> int:
    """Bytes of one client's payload (a row of each array): equal to
    ``leaf_wire_bytes`` for every kind."""
    return sum(a[0].numel() * a.element_size() for a in payload)


def make_compressor(cfg: CompressionConfig):
    """Returns compress(deltas, ckeys) -> deltas: the dequantized image of
    every client's delta, {name: (K, ...)} with the round's client keys
    ckeys (K, 2). Client k rounds leaf i of the reference's tree order
    (``jax_leaf_order``) with ``split(ckeys[k], L)[i]``, as the reference
    vmaps a compressor that splits its client key over the leaves. With
    ``cfg.packed`` every payload is materialized and unpacked."""
    if cfg.kind == "none":
        return lambda deltas, ckeys: deltas
    if cfg.kind == "topk" and not cfg.packed:
        return lambda deltas, ckeys: {n: _topk_leaf(d, cfg.topk_frac) for n, d in deltas.items()}

    def leaf_fn(x, kd):
        if cfg.packed:
            return unpack_leaf(cfg, pack_leaf(cfg, x, kd), x.shape, x.dtype)
        return _quantize_leaf(x, kd, _BITS[cfg.kind], cfg.stochastic)

    def compress(deltas: dict, ckeys: torch.Tensor) -> dict:
        names = jax_leaf_order(deltas)
        device = deltas[names[0]].device
        lkeys = keys_lib.split(ckeys.cpu(), len(names)).to(device) if cfg.stochastic else None
        out = {n: leaf_fn(deltas[n], None if lkeys is None else lkeys[:, i])
               for i, n in enumerate(names)}
        return {n: out[n] for n in deltas}

    return compress


# ----------------------------------------------------------------------
# The code-domain fast path.
# ----------------------------------------------------------------------


def sum_packed_codes(cfg: CompressionConfig, data, size: int, weights=None):
    """(K, nbytes) intN wire buffers -> (size,) int32 code sums, weighted
    by the clients' integral example counts ``weights`` (int32). ``data``
    is nibble-packed for a packed int4 plane and raw int8 codes otherwise.
    |sum| <= levels * sum(weights), exact in int32 below 2**31 / levels
    examples a round."""
    if cfg.kind not in _BITS:
        raise ValueError(f"sum_packed_codes is the intN code-domain reduction; a "
                         f"{cfg.kind!r} payload carries fp32 values, not codes")
    codes = wire_pack.nibble_unpack(data, size) if cfg.kind == "int4" and cfg.packed else data
    wide = codes.to(torch.int32)
    if weights is None:
        return wide.sum(dim=0, dtype=torch.int32)
    return (weights.to(torch.int32)[:, None] * wide).sum(dim=0, dtype=torch.int32)


def shared_leaf_scale(d: torch.Tensor, pmask: torch.Tensor, bits: int) -> torch.Tensor:
    """One scale for a client-stacked leaf d (K, ...): each reporting
    client's absmax, the max over the clients, over levels."""
    am = d.float().reshape(d.shape[0], -1).abs().amax(dim=1)
    return _over_levels((am * (pmask > 0)).max(), bits)


def fastpath_leaf_keys(ckeys: torch.Tensor, leaf_idx) -> torch.Tensor:
    """The clients' rounding keys for one leaf (or, with a tensor of
    indices, (L, 1) for many): the round's client keys (K, 2) folded with
    the leaf's index."""
    return keys_lib.fold_in(ckeys, leaf_idx)


def _leaf_keys(ckeys: torch.Tensor, n_leaves: int, device) -> torch.Tensor:
    """Every leaf's client keys (L, K, 2) at once, on ``device``."""
    idx = torch.arange(n_leaves, dtype=torch.int64)[:, None]
    return fastpath_leaf_keys(ckeys.cpu()[None], idx).to(device)


def _mean_divisor(n_k: torch.Tensor) -> torch.Tensor:
    return torch.clamp(n_k.float().sum(), min=1.0)


def _quantize_payload(stochastic: bool, flat, scale, kd, bits: int, pack: bool):
    """Each client's wire buffer (pack: the fused quantize-and-pack
    kernel) or its codes, stochastic (with the clients' keys kd) or
    nearest."""
    if stochastic:
        fn = wire_pack.quantize_pack_keyed if pack else wire_pack.quantize_with_scale_keyed
        return fn(flat, scale, kd, bits)
    fn = wire_pack.quantize_pack if pack else wire_pack.quantize_with_scale
    return fn(flat, scale, None, bits)


def code_domain_aggregate(cfg: CompressionConfig, deltas: dict, n_k: torch.Tensor,
                          pmask: torch.Tensor, ckeys: Optional[torch.Tensor]) -> dict:
    """The example-weighted mean of K compressed client deltas, stacked
    per leaf as {name: (K, ...)}, without per-client fp32 dequantization:

        intN: shared scale s -> quantize (+ pack) per client -> int32 code
              sum weighted by n_k -> wbar = csum * (s / n)
        topk: per-client (value, index) payload -> one weighted
              scatter-add -> wbar = sum / n

    ``ckeys`` (K, 2) are the round's client keys; leaf i of the
    reference's tree order (``jax_leaf_order``) rounds with
    ``fold_in(ckeys, i)``. Returns {name: wbar leaf}."""
    return _code_domain(cfg, deltas, n_k, pmask, ckeys, None)[0]


def code_domain_aggregate_ef(cfg: CompressionConfig, deltas: dict, n_k, pmask, ckeys,
                             ef: dict) -> tuple[dict, dict]:
    """Error-feedback twin of ``code_domain_aggregate`` (EF21): each
    client compresses ``delta + residual`` and the new residual comes
    from what it transmitted. intN: target - codes * scale; topk: the
    target with its sent coordinates zeroed. A client that does not
    report keeps its residual. Returns (wbar, new ef), both by name."""
    return _code_domain(cfg, deltas, n_k, pmask, ckeys, ef)


def _code_domain(cfg: CompressionConfig, deltas: dict, n_k, pmask, ckeys,
                 ef: Optional[dict]) -> tuple[dict, dict]:
    """Both fast paths, leaf by leaf in the reference's tree order; the
    new residuals only when ``ef`` is given (else an empty dict)."""
    if cfg.kind not in _BITS and cfg.kind != "topk":
        raise ValueError(f"the code-domain fast path compresses; kind {cfg.kind!r} does not")
    names = jax_leaf_order(deltas)
    n = _mean_divisor(n_k)
    sel = (pmask > 0)[:, None]
    bits = _BITS.get(cfg.kind)
    if bits is not None:
        w_int = torch.round(n_k).to(torch.int32)
        lkeys = _leaf_keys(ckeys, len(names), n_k.device) if cfg.stochastic else None
    out, ef_out = {}, {}
    for li, name in enumerate(names):
        d = deltas[name]
        target = d.float() if ef is None else d.float() + ef[name].float()
        flat = target.reshape(d.shape[0], -1)
        if bits is None:
            vals, idx = topk_select(flat, cfg.topk_frac)
            dsum = wire_pack.topk_scatter_add(vals, idx, n_k.float(), flat.shape[1])
            out[name] = (dsum / n).reshape(d.shape[1:])
            if ef is not None:
                resid = flat.scatter(1, idx.long(), 0.0)
        else:
            scale = shared_leaf_scale(target, pmask, bits)
            kd = None if lkeys is None else lkeys[li]
            if ef is None:
                payload = _quantize_payload(cfg.stochastic, flat, scale, kd, bits,
                                            pack=cfg.packed)
            else:
                # the residual needs the codes; a packed int4 plane still puts
                # the nibble bytes on the wire and reduces through them (pack
                # then unpack is the identity on the codes)
                codes = _quantize_payload(cfg.stochastic, flat, scale, kd, bits, pack=False)
                payload = wire_pack.nibble_pack(codes) if cfg.packed and bits == 4 else codes
                resid = flat - codes.float() * scale
            csum = sum_packed_codes(cfg, payload, flat.shape[1], weights=w_int)
            out[name] = (csum.float() * (scale / n)).reshape(d.shape[1:])
        if ef is not None:
            e = ef[name]
            ef_out[name] = torch.where(sel, resid, e.reshape(e.shape[0], -1)).reshape(
                e.shape).to(e.dtype)
    return out, ef_out
