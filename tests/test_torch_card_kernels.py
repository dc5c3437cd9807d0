"""The normal kernel and K7 (nibble pack, nibble unpack, dequantize) on a
CUDA card against their plain versions, bit for bit, at their run edges
(``threefry_normal.RUN_EDGES``, ``wire_pack.K7_RUN_EDGES``), and K10's
tensor-core backward against its plain version at chip_smoke.py's bf16
backward shapes, twice for the same bits; K10 and its backward at
multi-head latent attention's widths (q·k 192, v 128) and at widths up to
gemma3's 256 on both routes, and K11 at D = 256. A
CUDA kernel has no interpret
mode: without a card these tests skip. They take the cases chip_smoke.py
does not: at each normal edge the other dtype and another kind of scale
than its ``normal_edges``, K7 at K = 2 (chip_smoke takes K = 3 and 4), and
the backward on inputs drawn from other seeds. K12 (WKV-6) and K13
(Mamba2's scan), forward and backward, against their plain versions at
every width the kernels take (K13's P and N each way), at one step, one
full checkpoint chunk and one step past two, from a zero and a given
state; each call twice for the same bits (a forward's y the same without
checkpoints), a 129-step forward the same bits as 64 steps continued by 65
from their state, the launch counts, the backwards on a fresh thread, the
blocks against ``bwd_geometry`` and ``fwd_geometry``, a forward's copy of
inputs that start off 16 bytes, the dispatch of the model's calls (the
autograd Function under grad, the forward alone without) and the kernels'
refusals (bf16, strided tensors, misaligned ones to a backward, other
head sizes).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card_kernels.py
"""

import threading

import pytest
import torch

from repro_torch.core import keys
from repro_torch.kernels import (
    decode_attention,
    flash_attention,
    ref,
    ssm_scan,
    threefry_normal,
    wire_pack,
    wkv6,
)

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
    ("zamba2-7b heads", 4, 128, 128, 32, 32, 112, 112, True, None, 0.0, 0, None),
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


# K10 at multi-head latent attention's widths (D = 192, Dv = 128), as
# chip_smoke.py's K10_SHAPES rows: deepseek-v2-lite-16b's layout (16 heads,
# MLA's scale) and the contract's cases (a window, a softcap, H = 2 Kv,
# ragged Sq and Sk, a query offset); bf16 takes the tensor cores (the
# forward's ND = 3, the backward's two-warpgroup dK/dV), fp32 the CUDA
# cores. chip_smoke.py's ATTN_TOL and ATTN_BWD_TOL.
K10_D192_SHAPES = (
    ("deepseek-v2-lite heads", 4, 128, 128, 16, 16, 192, 128, True, None, 0.0, 0, 192 ** -0.5),
    ("d192 gqa window softcap", 2, 100, 130, 4, 2, 192, 128, True, 40, 30.0, 30, None),
)
FWD_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (4e-3, 8e-3)}
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: BWD_BF16_TOL}


def _k10_and_its_backward_against_plain(card, shape, dtype):
    _, B, Sq, Sk, H, Kv, D, Dv, causal, window, cap, off, scale = shape
    gen = torch.Generator(device=card).manual_seed(B * Sq + 3 * Sk + H)
    q, k, v, do = (torch.randn(sh, generator=gen, device=card).to(dtype) for sh in
                   ((B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, Dv), (B, Sq, H, Dv)))
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=off, scale=scale)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    o, lse = flash_attention.flash_attention_fwd_lse(q, k, v, **kw)
    assert flash_attention.route(q, k, v) == flash_attention.bwd_route(q, k, v, o, do) == route
    atol, rtol = FWD_TOL[dtype]
    torch.testing.assert_close(o.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
                               atol=atol, rtol=rtol)
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        top = max(float(w.float().abs().max()), 1.0)
        assert float((g.float() - w.float()).abs().max()) <= BWD_TOL[dtype] * top
    again = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert torch.equal(flash_attention.flash_attention(q, k, v, **kw), o)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", K10_D192_SHAPES, ids=lambda sh: sh[0])
def test_k10_and_its_backward_at_mla_widths_are_their_plain_versions_on_the_card(card, shape,
                                                                                 dtype):
    _k10_and_its_backward_against_plain(card, shape, dtype)


# K10 and its backward at head widths past 192 and 128, up to gemma3's 256
# (D = Dv = 256): 8 heads on 4 kv heads with the window acting, a ragged
# length with a window, softcap and query offset, Dv past 128 with D = 64,
# D = 256 with Dv = 144 (the wide forward's second warpgroup over 64
# columns, 16 of them stored), D = 208 against Dv = 48, and D = 192 against
# Dv = 160 (the backward's split kernel at NV = 3, not the halves). bf16
# takes the tensor cores, fp32 the CUDA cores. Beside each, the launches
# (forward, backward) on the instantiations counted apart: on the tensor
# cores the forward's two warpgroups (Dv > 128) and the backward's column
# halves (ND or NV = 4), on the CUDA cores the tiles of 256 (max(D, Dv) >
# 192); the forward runs twice (with its lse, alone), the backward twice.
K10_D256_SHAPES = (
    ("gemma3 local", 1, 384, 384, 8, 4, 256, 256, True, 128, 0.0, 0, None),
    ("d256 gqa window softcap", 2, 100, 130, 4, 2, 256, 256, True, 40, 30.0, 30, None),
    ("d64 dv256", 2, 70, 70, 2, 1, 64, 256, True, None, 0.0, 0, None),
    ("d256 dv144", 1, 70, 90, 2, 2, 256, 144, False, None, 0.0, 0, None),
    ("d208 dv48", 1, 65, 65, 4, 1, 208, 48, True, 20, 0.0, 0, 0.05),
    ("d192 dv160", 1, 90, 120, 4, 2, 192, 160, True, 50, 0.0, 0, None),
)
K10_D256_WIDE = {"d208 dv48": {"WGMMA": [0, 2], "SIMT": [2, 2]},
                 "d192 dv160": {"WGMMA": [2, 0], "SIMT": [0, 0]}}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", K10_D256_SHAPES, ids=lambda sh: sh[0])
def test_k10_and_its_backward_at_width_256_are_their_plain_versions_on_the_card(card, shape,
                                                                                dtype):
    route = "WGMMA" if dtype == torch.bfloat16 else "SIMT"
    names = (f"{route}_WIDE_LAUNCHES", f"BWD_{route}_WIDE_LAUNCHES")
    before = [getattr(flash_attention, n) for n in names]
    _k10_and_its_backward_against_plain(card, shape, dtype)
    want = K10_D256_WIDE.get(shape[0], {}).get(route, [2, 2])
    assert [getattr(flash_attention, n) - b for n, b in zip(names, before)] == want


# K11 at gemma3's heads (G = 2, D = 256) over a cache of 1,184 slots with the
# window of 1,024 acting and without it, a ring of 1,024 slots, and D = 256
# against Dv = 200 at G = 16 (the widest partial sums): bf16 and fp32 against
# the plain version (chip_smoke.py's ATTN_TOL), twice for the same bits.
K11_D256_SHAPES = (
    ("gemma3 serve", 4, 1184, 8, 4, 256, 256, 1183, 1024, False),
    ("gemma3 serve global", 4, 1184, 8, 4, 256, 256, 1183, None, False),
    ("d256 ring", 2, 1024, 4, 2, 256, 256, 1500, 1024, True),
    ("d256 dv200 g16", 1, 300, 16, 1, 256, 200, 250, None, False),
)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", K11_D256_SHAPES, ids=lambda sh: sh[0])
def test_k11_at_width_256_is_its_plain_version_on_the_card(card, shape, dtype):
    _, B, S, H, Kv, D, Dv, pos, window, ring = shape
    gen = torch.Generator(device=card).manual_seed(S + D + Dv)
    q, kc, vc = (torch.randn(sh, generator=gen, device=card).to(dtype) for sh in
                 ((B, H, D), (B, S, Kv, D), (B, S, Kv, Dv)))
    pos_t = torch.full((), pos, dtype=torch.int32, device=card)
    kw = dict(window=window, ring=ring)
    before = decode_attention.WIDE_LAUNCHES
    got = decode_attention.flash_decode(q, kc, vc, pos_t, **kw)
    torch.cuda.synchronize()
    assert decode_attention.WIDE_LAUNCHES == before + 1
    atol, rtol = FWD_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(q, kc, vc, pos_t, **kw).float(),
                               atol=atol, rtol=rtol)
    assert torch.equal(decode_attention.flash_decode(q, kc, vc, pos_t, **kw), got)


# K12 and K13 in fp32 against their plain versions: the same products summed
# in another order over up to 129 steps, relative to the largest entry
SCAN_TOL = 2e-6


def _err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


# the backwards' cases: every width the kernels take, one step, one full
# checkpoint chunk and one step past two, from a zero and a given state
SCAN_LENGTHS = (1, 64, 129)


def _k12_inputs(card, B, S, H, P, from_state, seed):
    shape = (B, S, H, P)
    gen = torch.Generator(device=card).manual_seed(seed)
    r, k, v, dy = (torch.randn(shape, generator=gen, device=card) * 0.5 for _ in range(4))
    w = torch.exp(-torch.exp(torch.randn(shape, generator=gen, device=card) * 0.5 - 1.0))
    u = torch.randn((H, P), generator=gen, device=card) * 0.1
    S0 = torch.randn((B, H, P, P), generator=gen, device=card) * 0.1 if from_state else None
    dS = torch.randn((B, H, P, P), generator=gen, device=card) if from_state else None
    return (r, k, v, w, u), S0, dy, dS


@pytest.mark.parametrize("S", SCAN_LENGTHS)
@pytest.mark.parametrize("P", wkv6.HEAD_SIZES)
@pytest.mark.parametrize("from_state", [False, True], ids=["zero", "state"])
def test_k12_is_its_plain_version_on_the_card(card, P, S, from_state):
    B, H = (3, 4) if P < 64 else (1, 2)
    ins, S0, dy, dS = _k12_inputs(card, B, S, H, P, from_state, S * P + from_state)
    f0, b0 = wkv6.FWD_LAUNCHES, wkv6.BWD_LAUNCHES
    y, ST, ck = wkv6.wkv6_fwd(*ins, S0, checkpoints=True)
    grads = wkv6.wkv6_bwd(*ins, ck, dy, dS)
    torch.cuda.synchronize()
    assert (wkv6.FWD_LAUNCHES, wkv6.BWD_LAUNCHES) == (f0 + 1, b0 + 1)
    want = ref.wkv6_fwd_ref(*ins, S0, wkv6.CHUNK)
    for name, g, w_ in zip(("y", "S_T", "checkpoints"), (y, ST, ck), want):
        assert _err(g, w_) <= SCAN_TOL, name
    want = ref.wkv6_bwd_ref(*ins, want[2], dy, dS, wkv6.CHUNK)
    for name, g, w_ in zip(("dr", "dk", "dv", "dw", "du", "dS0"), grads, want):
        assert g.shape == w_.shape and _err(g, w_) <= SCAN_TOL, name
    again = wkv6.wkv6_bwd(*ins, ck, dy, dS)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))
    # the forward twice: the same bits, and y the same without checkpoints
    again = wkv6.wkv6_fwd(*ins, S0, checkpoints=True)
    assert all(torch.equal(a, g) for a, g in zip(again, (y, ST, ck)))
    assert torch.equal(wkv6.wkv6_fwd(*ins, S0)[0], y)


def _k13_inputs(card, B, S, H, P, N, from_state, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    x, dy = (torch.randn((B, S, H, P), generator=gen, device=card) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=card) - 3.0)
    a = torch.exp(dt * -torch.linspace(1.0, 16.0, H, device=card))
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device=card) for _ in range(2))
    h0 = torch.randn((B, H, P, N), generator=gen, device=card) * 0.1 if from_state else None
    dh = torch.randn((B, H, P, N), generator=gen, device=card) if from_state else None
    return (x, dt, a, Bm, Cm), h0, dy, dh


@pytest.mark.parametrize("S", SCAN_LENGTHS)
@pytest.mark.parametrize("P, N", [(p, n) for p in ssm_scan.WIDTHS for n in ssm_scan.WIDTHS])
@pytest.mark.parametrize("from_state", [False, True], ids=["zero", "state"])
def test_k13_is_its_plain_version_on_the_card(card, P, N, S, from_state):
    B, H = (2, 3) if P * N < 4096 else (1, 2)
    ins, h0, dy, dh = _k13_inputs(card, B, S, H, P, N, from_state, S * N + P + from_state)
    f0, b0 = ssm_scan.FWD_LAUNCHES, ssm_scan.BWD_LAUNCHES
    y, hT, ck = ssm_scan.ssm_scan_fwd(*ins, h0, checkpoints=True)
    grads = ssm_scan.ssm_scan_bwd(*ins, ck, dy, dh)
    torch.cuda.synchronize()
    assert (ssm_scan.FWD_LAUNCHES, ssm_scan.BWD_LAUNCHES) == (f0 + 1, b0 + 1)
    want = ref.ssm_scan_fwd_ref(*ins, h0, ssm_scan.CHUNK)
    for name, g, w_ in zip(("y", "h_T", "checkpoints"), (y, hT, ck), want):
        assert _err(g, w_) <= SCAN_TOL, name
    want = ref.ssm_scan_bwd_ref(*ins, want[2], dy, dh, ssm_scan.CHUNK)
    for name, g, w_ in zip(("dx", "ddt", "da", "dB", "dC", "dh0"), grads, want):
        assert g.shape == w_.shape and _err(g, w_) <= SCAN_TOL, name
    again = ssm_scan.ssm_scan_bwd(*ins, ck, dy, dh)
    assert all(torch.equal(p, g) for p, g in zip(again, grads))
    # the forward twice: the same bits, and y the same without checkpoints
    again = ssm_scan.ssm_scan_fwd(*ins, h0, checkpoints=True)
    assert all(torch.equal(p, g) for p, g in zip(again, (y, hT, ck)))
    assert torch.equal(ssm_scan.ssm_scan_fwd(*ins, h0)[0], y)


@pytest.mark.parametrize("kind, P, N", [("wkv6", p, p) for p in wkv6.HEAD_SIZES]
                         + [("ssm_scan", p, n) for p in ssm_scan.WIDTHS for n in (16, 64)])
def test_k12_and_k13_forwards_continue_from_their_state_bit_for_bit(card, kind, P, N):
    """Prefill then continue, as the serves do: 129 steps from a state give
    the y and final state of 64 steps followed by 65 from the state those
    returned, bit for bit (64 is a whole number of sub-chunks and chunks)."""
    if kind == "wkv6":
        ins, state, _, _ = _k12_inputs(card, 2, 129, 3, P, True, 7 * P)
        fwd = wkv6.wkv6_fwd
    else:
        ins, state, _, _ = _k13_inputs(card, 2, 129, 3, P, N, True, 7 * P + N)
        fwd = ssm_scan.ssm_scan_fwd
    y, last, _ = fwd(*ins, state)
    head = [t if t.dim() == 2 else t[:, :64].contiguous() for t in ins]  # u (H, P) stays
    tail = [t if t.dim() == 2 else t[:, 64:].contiguous() for t in ins]
    y0, mid, _ = fwd(*head, state)
    y1, end, _ = fwd(*tail, mid)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y0, y1], dim=1), y)
    assert torch.equal(end, last)


def test_k12_and_k13_backwards_on_a_thread_with_no_cuda_work_yet(card):
    """The backwards encode their TMA maps with a driver call that needs a
    current context, and wait on mbarriers: on a fresh thread (autograd's
    device thread, when a backward is its first CUDA work) they give the
    bits they give here."""
    ins12, S0, dy12, dS = _k12_inputs(card, 2, 70, 3, 64, True, 12)
    ck12 = wkv6.wkv6_fwd(*ins12, S0, checkpoints=True)[2]
    ins13, h0, dy13, dh = _k13_inputs(card, 2, 70, 3, 64, 32, True, 13)
    ck13 = ssm_scan.ssm_scan_fwd(*ins13, h0, checkpoints=True)[2]
    want = (wkv6.wkv6_bwd(*ins12, ck12, dy12, dS), ssm_scan.ssm_scan_bwd(*ins13, ck13, dy13, dh))
    out = {}

    def work():
        try:
            out["grads"] = (wkv6.wkv6_bwd(*ins12, ck12, dy12, dS),
                            ssm_scan.ssm_scan_bwd(*ins13, ck13, dy13, dh))
            torch.cuda.synchronize()
        except RuntimeError as e:  # reported below, on the test's thread
            out["error"] = e

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert "error" not in out, out.get("error")
    for got, ref_ in zip(out["grads"], want):
        assert all(torch.equal(g, w_) for g, w_ in zip(got, ref_))


def test_k12_and_k13_backward_blocks_are_their_geometry_on_the_card(card):
    """The built kernels' threads and shared memory are what
    ``bwd_geometry`` lays out, and a block fits an SM at every width."""
    for P in wkv6.HEAD_SIZES:
        info, geo = wkv6.bwd_info(P), wkv6.bwd_geometry(P)
        assert (info["threads"], info["shared_bytes"]) == (geo["threads"], geo["shared_bytes"])
        assert info["blocks_per_sm"] >= 1, (P, info)
    for P in ssm_scan.WIDTHS:
        for N in ssm_scan.WIDTHS:
            info, geo = ssm_scan.bwd_info(P, N), ssm_scan.bwd_geometry(P, N)
            assert (info["threads"], info["shared_bytes"]) == (geo["threads"],
                                                               geo["shared_bytes"])
            assert info["blocks_per_sm"] >= 1, (P, N, info)


def test_k12_and_k13_forward_blocks_are_their_geometry_on_the_card(card):
    """The built forwards' threads, shared memory and blocks a (b, h) are
    what ``fwd_geometry`` lays out, and a block fits an SM at every width."""
    for P in wkv6.HEAD_SIZES:
        info, geo = wkv6.fwd_info(P), wkv6.fwd_geometry(P)
        assert (info["threads"], info["shared_bytes"], info["blocks"]) == \
            (geo["threads"], geo["shared_bytes"], geo["blocks"])
        assert info["blocks_per_sm"] >= 1, (P, info)
    for P in ssm_scan.WIDTHS:
        for N in ssm_scan.WIDTHS:
            info, geo = ssm_scan.fwd_info(P, N), ssm_scan.fwd_geometry(P, N)
            assert (info["threads"], info["shared_bytes"], info["blocks"]) == \
                (geo["threads"], geo["shared_bytes"], geo["blocks"])
            assert info["blocks_per_sm"] >= 1, (P, N, info)


def test_k12_and_k13_forwards_copy_a_view_that_starts_off_16_bytes(card):
    """The forwards read TMA boxes and 16-byte pieces of the state: a
    contiguous view one float into its storage (as a cache's view may be)
    is copied by the wrapper and computed, not refused; the same bits as
    the aligned tensors give."""
    def off(t):
        return torch.empty(t.numel() + 1, device=card)[1:].view(t.shape).copy_(t)

    ins, S0, _, _ = _k12_inputs(card, 2, 9, 3, 32, True, 41)
    want = wkv6.wkv6_fwd(*ins, S0, checkpoints=True)
    got = wkv6.wkv6_fwd(*(off(t) for t in ins), off(S0), checkpoints=True)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    ins, h0, _, _ = _k13_inputs(card, 2, 9, 3, 32, 16, True, 43)
    want = ssm_scan.ssm_scan_fwd(*ins, h0, checkpoints=True)
    got = ssm_scan.ssm_scan_fwd(*(off(t) for t in ins), off(h0), checkpoints=True)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


def test_k12_and_k13_dispatch_and_refusals_on_the_card(card):
    gen = torch.Generator(device=card).manual_seed(3)
    r = torch.randn((2, 8, 2, 16), generator=gen, device=card)
    u = torch.zeros((2, 16), device=card)
    x = torch.randn((2, 8, 2, 16), generator=gen, device=card)
    dt = torch.rand((2, 8, 2), generator=gen, device=card)
    Bm = torch.randn((2, 8, 16), generator=gen, device=card)
    # the model's calls: the forward alone without grad, the Function with it
    f12, b12, f13, b13 = (wkv6.FWD_LAUNCHES, wkv6.BWD_LAUNCHES, ssm_scan.FWD_LAUNCHES,
                          ssm_scan.BWD_LAUNCHES)
    with torch.no_grad():
        wkv6.wkv6(r, r, r, r.sigmoid(), u)
        ssm_scan.ssm_scan(x, dt, dt, Bm, Bm)
    rg = r.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    wkv6.wkv6(rg, r, r, r.sigmoid(), u)[0].sum().backward()
    ssm_scan.ssm_scan(xg, dt, dt, Bm, Bm)[0].sum().backward()
    torch.cuda.synchronize()
    assert (wkv6.FWD_LAUNCHES - f12, wkv6.BWD_LAUNCHES - b12) == (2, 1)
    assert (ssm_scan.FWD_LAUNCHES - f13, ssm_scan.BWD_LAUNCHES - b13) == (2, 1)
    assert torch.isfinite(rg.grad).all() and torch.isfinite(xg.grad).all()
    with pytest.raises(TypeError, match="float32"):
        wkv6.wkv6_fwd(r.bfloat16(), r.bfloat16(), r.bfloat16(), r.bfloat16(), u.bfloat16())
    strided = r.transpose(0, 1).contiguous().transpose(0, 1)  # r's shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        wkv6.wkv6_fwd(strided, r, r, r, u)
    r48 = torch.zeros((1, 2, 1, 48), device=card)
    with pytest.raises(ValueError, match="P in"):
        wkv6.wkv6_fwd(r48, r48, r48, r48, torch.zeros((1, 48), device=card))
    with pytest.raises(TypeError, match="float32"):
        ssm_scan.ssm_scan_fwd(x.bfloat16(), dt, dt, Bm, Bm)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan.ssm_scan_fwd(x, dt, dt, Bm.transpose(0, 1).contiguous().transpose(0, 1), Bm)
    with pytest.raises(ValueError, match="P and N in"):
        ssm_scan.ssm_scan_fwd(x, dt, dt, Bm[..., :8].contiguous(), Bm[..., :8].contiguous())
    with pytest.raises(ValueError, match="several devices"):
        ssm_scan.ssm_scan_fwd(x, dt.cpu(), dt, Bm, Bm)
    # the backwards' TMA boxes need 16-byte-aligned inputs: a contiguous view
    # one float into its storage is refused
    ck12 = wkv6.wkv6_fwd(r, r, r, r.sigmoid(), u, checkpoints=True)[2]
    r_off = torch.empty(r.numel() + 1, device=card)[1:].view(r.shape).copy_(r)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        wkv6.wkv6_bwd(r_off, r, r, r.sigmoid(), u, ck12, r)
    ck13 = ssm_scan.ssm_scan_fwd(x, dt, dt, Bm, Bm, checkpoints=True)[2]
    B_off = torch.empty(Bm.numel() + 1, device=card)[1:].view(Bm.shape).copy_(Bm)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        ssm_scan.ssm_scan_bwd(x, dt, dt, B_off, Bm, ck13, x)


def test_k10_tensor_core_backward_on_a_thread_with_no_cuda_work_yet(card):
    """The TMA encoding is a driver call that needs a current context: on a
    fresh thread (as autograd's device thread, when K10's backward is its
    first CUDA work) it once failed with CUDA_ERROR_INVALID_CONTEXT."""
    gen = torch.Generator(device=card).manual_seed(112)
    q, k, v, do = (torch.randn((2, 64, 4, 112), generator=gen, device=card).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = flash_attention.flash_attention_fwd_lse(q, k, v)
    want = flash_attention.flash_attention_bwd(q, k, v, o, lse, do)
    out = {}

    def work():
        try:
            out["grads"] = flash_attention.flash_attention_bwd(q, k, v, o, lse, do)
            torch.cuda.synchronize()
        except RuntimeError as e:  # reported below, on the test's thread
            out["error"] = e

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert "error" not in out, out.get("error")
    assert all(torch.equal(g, w) for g, w in zip(out["grads"], want))
