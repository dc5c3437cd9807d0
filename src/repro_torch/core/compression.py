"""Wire-byte accounting of the uplink (``repro/core/compression.py:108-128``).

Only ``kind == "none"`` is ported: a client uploads its fp32 delta and
the server broadcasts the full model. The quantizing and top-k planes
wait for ROADMAP M6. Byte counts are exact Python ints.
"""

from __future__ import annotations

_WORD = 4  # bytes of one fp32 value on the wire


def client_wire_bytes(kind: str, params: dict) -> int:
    """Exact per-client uplink bytes for one delta."""
    if kind != "none":
        raise NotImplementedError(f"compression {kind!r}: ROADMAP M6")
    return sum(_WORD * p.numel() for p in params.values())


def tree_param_bytes(params: dict) -> int:
    """Downlink bytes: the server broadcasts the full model."""
    return sum(p.numel() * p.element_size() for p in params.values())
