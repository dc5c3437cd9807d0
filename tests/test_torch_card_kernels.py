"""The normal kernel and K7 (nibble pack, nibble unpack, dequantize) on a
CUDA card against their plain versions, bit for bit, at their run edges
(``threefry_normal.RUN_EDGES``, ``wire_pack.K7_RUN_EDGES``), and K10's
tensor-core backward against its plain version at chip_smoke.py's bf16
backward shapes, twice for the same bits. A CUDA kernel has no interpret
mode: without a card these tests skip. They take the cases chip_smoke.py
does not: at each normal edge the other dtype and another kind of scale
than its ``normal_edges``, K7 at K = 2 (chip_smoke takes K = 3 and 4), and
the backward on inputs drawn from other seeds.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card_kernels.py
"""

import pytest
import torch

from repro_torch.core import keys
from repro_torch.kernels import flash_attention, ref, threefry_normal, wire_pack

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and run only there")
    return torch.device("cuda")


def _scale(kind: str, device):
    if kind == "value":
        return 0.01
    if kind == "device":
        return torch.tensor(0.02, device=device)
    return torch.tensor([0.5, 0.0, -1.5, 0.01], device=device)


@pytest.mark.parametrize("i", range(len(threefry_normal.RUN_EDGES)))
def test_normal_axpy_is_its_plain_version_on_the_card(card, i):
    numel = threefry_normal.RUN_EDGES[i]
    kinds = ("device", "slices", "value") if numel % 4 == 0 else ("device", "value")
    dname, kind = ("bfloat16", "float32")[i % 2], kinds[i % len(kinds)]
    gen = torch.Generator(device=card).manual_seed(numel)
    x = torch.randn(numel, generator=gen, device=card).to(getattr(torch, dname))
    kd = keys.split(keys.PRNGKey(numel), 1)
    s = _scale(kind, card)
    got = threefry_normal.normal_axpy([x], kd, [s])[0]
    assert torch.equal(got, ref.normal_axpy_ref([x], kd, [s])[0])


@pytest.mark.parametrize("n", wire_pack.K7_RUN_EDGES + (4_097,))
def test_k7_is_its_plain_version_on_the_card(card, n):
    gen = torch.Generator(device=card).manual_seed(n)
    codes = torch.randint(-8, 8, (2, n), generator=gen, device=card, dtype=torch.int8)
    packed = wire_pack.nibble_pack(codes)
    assert torch.equal(packed, ref.nibble_pack_ref(codes))
    assert torch.equal(wire_pack.nibble_unpack(packed, n), codes)
    codes8 = torch.randint(-127, 128, (2, n), generator=gen, device=card, dtype=torch.int8)
    scales = torch.rand(2, generator=gen, device=card) * 1e-3 + 1e-5
    for scale in (scales, scales[1]):
        assert torch.equal(wire_pack.dequantize(codes8, scale), ref.dequantize_ref(codes8, scale))


# chip_smoke.py's K10_BWD_SHAPES: whisper-base's training shapes (the
# encoder, the decoder's causal self-attention and its cross-attention), a
# ragged GQA row with a window, softcap, query offset and scale (D=96,
# Dv=80), rows with no valid key, and qwen3-8b's head layout. (name, B, Sq,
# Sk, H, Kv, D, Dv, causal, window, softcap, q_offset, scale)
K10_BWD_SHAPES = (
    ("train encoder", 4, 384, 384, 8, 8, 64, 64, False, None, 0.0, 0, None),
    ("train causal self", 4, 48, 48, 8, 8, 64, 64, True, None, 0.0, 0, None),
    ("train cross", 4, 48, 384, 8, 8, 64, 64, False, None, 0.0, 0, None),
    ("gqa window softcap", 2, 333, 517, 8, 2, 96, 80, True, 100, 30.0, 184, 0.1),
    ("no valid key", 1, 40, 16, 2, 1, 16, 16, True, 4, 0.0, 0, None),
    ("qwen3-8b heads", 4, 128, 128, 32, 8, 128, 128, True, None, 0.0, 0, None),
)
# chip_smoke.py's ATTN_BWD_TOL for bf16: one bf16 ulp of the largest entry
BWD_BF16_TOL = 8e-3


@pytest.mark.parametrize("shape", K10_BWD_SHAPES, ids=lambda sh: sh[0])
def test_k10_tensor_core_backward_is_its_plain_version_on_the_card(card, shape):
    _, B, Sq, Sk, H, Kv, D, Dv, causal, window, cap, off, scale = shape
    gen = torch.Generator(device=card).manual_seed(B * Sq + 7 * Sk + D)
    q, k, v, do = (torch.randn(sh, generator=gen, device=card).to(torch.bfloat16) for sh in
                   ((B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, Dv), (B, Sq, H, Dv)))
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=off, scale=scale)
    o, lse = flash_attention.flash_attention_fwd_lse(q, k, v, **kw)
    assert flash_attention.bwd_route(q, k, v, o, do) == "wgmma"
    before = flash_attention.BWD_WGMMA_LAUNCHES
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention.BWD_WGMMA_LAUNCHES == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        top = max(float(w.float().abs().max()), 1.0)
        assert float((g.float() - w.float()).abs().max()) <= BWD_BF16_TOL * top
    mask = ref.attention_mask(Sq, Sk, causal, window, off, "cpu")
    dead = (~mask.any(dim=1)).to(card)
    assert torch.equal(got[0][:, dead], torch.zeros_like(got[0][:, dead]))
    again = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
