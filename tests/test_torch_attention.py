"""The port's attention against the JAX package: K10's and K11's plain
versions (what the wrappers run on the CPU) against the Pallas kernels in
interpret mode where their tile rules admit the shape, and against the
model's jnp functions where they do not (ragged S, a query offset, a
query scale, a ring buffer) and for rows with no valid key (F5); the
projections, norms, rope, MLP and LM loss against ``repro.models``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as jax_flash_decode
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.convert import params_from_jax
from repro_torch.kernels import decode_attention as K11
from repro_torch.kernels import flash_attention as K10
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

# fp32: sums of D products and of Sk terms in another order; bf16: the
# output rounded to bf16 on both sides (tests/test_kernels.py:22)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shapes, dtype: str, seed: int):
    """Normal draws from numpy, rounded to the dtype once and shared."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s).astype(np.float32), JDT[dtype]) for s in shapes]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype]) for j in js]
    return js, ts


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ------------------------------------------------------------------ K10

# shapes the Pallas kernel admits (Sq % tq == 0, Sk % tk == 0 at tq = tk = 64)
PALLAS_SHAPES = [  # B, Sq, Sk, H, Kv, D, causal, window, softcap
    (2, 128, 128, 4, 2, 32, True, 0, 0.0),
    (1, 128, 128, 4, 4, 16, True, 32, 0.0),
    (2, 64, 128, 4, 1, 32, False, 0, 0.0),
    (1, 64, 64, 2, 2, 64, True, 0, 30.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=str)
def test_flash_attention_plain_is_the_pallas_kernel(shape, dtype):
    B, Sq, Sk, H, Kv, D, causal, window, cap = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, D)],
                                         dtype, Sq + Sk + H)
    want = jax_flash_attention(jq, jk, jv, causal=causal, window=window, logit_softcap=cap,
                               tq=64, tk=64, interpret=True)
    before = K10.FWD_LAUNCHES
    got = K10.flash_attention(tq, tk, tv, causal=causal, window=window, logit_softcap=cap)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (B, Sq, H, D)
    assert K10.FWD_LAUNCHES == before  # the CPU takes the plain version
    _close(got, want, dtype)


# shapes the Pallas rule refuses: ragged S, a query offset, a query scale,
# Whisper's 1,500-frame cross shape cut down, and block sizes that divide Sk
RAGGED_SHAPES = [  # B, Sq, Sk, H, Kv, D, Dv, causal, window, softcap, q_offset, scale, block_kv
    (2, 37, 37, 4, 2, 16, 16, True, None, 0.0, 0, None, 512),
    (1, 5, 150, 4, 4, 16, 16, False, None, 0.0, 0, None, 512),
    (2, 19, 45, 6, 2, 32, 24, True, 9, 20.0, 26, 0.1, 15),
    (1, 7, 30, 2, 1, 8, 8, True, 4, 0.0, 23, None, 7),
    (1, 33, 1030, 2, 2, 16, 16, False, None, 0.0, 0, None, 512),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=str)
def test_flash_attention_plain_is_blockwise_attention(shape, dtype):
    B, Sq, Sk, H, Kv, D, Dv, causal, window, cap, off, scale, bkv = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, Dv)],
                                         dtype, Sq * Sk + D)
    want = jattn.blockwise_attention(jq, jk, jv, causal=causal, window=window,
                                     logit_softcap=cap, q_offset=off, block_kv=bkv,
                                     query_scale=scale)
    got = tattn.blockwise_attention(tq, tk, tv, causal=causal, window=window,
                                    logit_softcap=cap, q_offset=off, block_kv=bkv,
                                    query_scale=scale)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (B, Sq, H, Dv)
    _close(got, want, dtype)


def test_block_kv_is_the_largest_divisor_at_or_below_512():
    assert [ref.attention_block_kv(s) for s in (1500, 448, 4, 1030, 1031, 512, 1024)] == \
        [500, 448, 4, 206, 1, 512, 512]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_with_no_valid_key_give_zero(dtype):
    """F5: causal with a window and Sq >= Sk + window leaves rows 5-7 with
    no valid key. The model's function and the Pallas kernel give 0 there;
    ``attention_ref``'s softmax over equal -1e30 scores gives the mean of v."""
    B, Sq, Sk, H, Kv, D = 1, 8, 4, 2, 1, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, D)],
                                         dtype, 5)
    got = K10.flash_attention(tq, tk, tv, causal=True, window=2)
    want = jattn.blockwise_attention(jq, jk, jv, causal=True, window=2)
    _close(got, want, dtype)
    assert torch.equal(got[0, 5:], torch.zeros_like(got[0, 5:]))
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=True, window=2), np.float32)
    assert np.abs(oracle[0, 5:]).max() > 0.1  # the oracle F5 names differs there
    np.testing.assert_allclose(got[0, :5].float().numpy(), oracle[0, :5], atol=TOL[dtype],
                               rtol=TOL[dtype])


# K10's backward: the plain version (``ref.flash_attention_bwd_ref``, the
# backward kernel's equations from o and the log-sum-exp) and the CPU
# wrapper's autograd against jax.grad of the model's blockwise_attention
GRAD_SHAPES = [  # B, Sq, Sk, H, Kv, D, Dv, causal, window, softcap, q_offset, scale
    (2, 37, 37, 4, 2, 16, 16, True, None, 0.0, 0, None),      # causal, GQA
    (1, 5, 70, 4, 4, 16, 16, False, None, 0.0, 0, None),      # not causal, Sq != Sk
    (2, 19, 45, 6, 2, 32, 24, True, 9, 20.0, 26, 0.1),        # window, softcap, q_offset
    (1, 12, 20, 2, 1, 8, 8, False, 5, 0.0, 0, None),          # window, not causal
    (1, 6, 10, 2, 2, 8, 8, True, None, 0.0, -3, None),        # rows 0-2: no valid key (F5)
    (2, 40, 40, 8, 2, 128, 128, True, None, 0.0, 0, None),    # qwen3-8b's head layout, small
    (1, 29, 53, 4, 2, 64, 48, True, 16, 30.0, 11, None),      # D != Dv, window, softcap, ragged
]
# fp32: sums over Sk and D in another order; bf16: the gradients rounded to
# bf16 on both sides (the fp32 sums agree to ~1e-6)
GRAD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=str)
def test_flash_attention_grads_are_jax_grad_of_blockwise_attention(shape, dtype):
    B, Sq, Sk, H, Kv, D, Dv, causal, window, cap, off, scale = shape
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        [(B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, Dv), (B, Sq, H, Dv)], dtype, Sq + 7 * Sk)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=off)

    def f(q, k, v):
        out = jattn.blockwise_attention(q, k, v, query_scale=scale, **kw)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jq, jk, jv)
    o, lse = K10.flash_attention_fwd_lse(tq, tk, tv, scale=scale, **kw)
    plain = K10.flash_attention_bwd(tq, tk, tv, o, lse, tdo, scale=scale, **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = K10.flash_attention(*leaves, scale=scale, **kw)
    auto = torch.autograd.grad(out, leaves, tdo)
    for name, p, a, w in zip("qkv", plain, auto, want):
        w = np.asarray(w.astype(jnp.float32))
        assert p.dtype == TDT[dtype] and p.shape == a.shape == w.shape, name
        for got in (p, a):
            np.testing.assert_allclose(got.float().numpy(), w,
                                       atol=GRAD_TOL[dtype] * max(1.0, np.abs(w).max()),
                                       rtol=GRAD_TOL[dtype], err_msg=name)
    dead = ~ref.attention_mask(Sq, Sk, causal, window, off, "cpu").any(dim=1)
    assert torch.isinf(lse[:, :, dead]).all() and torch.isfinite(lse[:, :, ~dead]).all()
    assert torch.equal(plain[0][:, dead], torch.zeros_like(plain[0][:, dead]))


# ------------------------------------------------------------------ K11

PALLAS_DECODE = [  # B, S, H, Kv, D, window, pos
    (2, 512, 8, 2, 32, 0, 173),
    (1, 256, 4, 4, 16, 64, 200),
    (3, 128, 2, 1, 64, 0, 0),
    (1, 448, 8, 8, 64, 0, 447),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PALLAS_DECODE, ids=str)
def test_flash_decode_plain_is_the_pallas_kernel(shape, dtype):
    B, S, H, Kv, D, window, pos = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, H, D), (B, S, Kv, D), (B, S, Kv, D)], dtype,
                                         S + pos)
    want = jax_flash_decode(jq, jk, jv, jnp.asarray(pos, jnp.int32), window=window, ts=64,
                            interpret=True)
    before = K11.FWD_LAUNCHES
    got = K11.flash_decode(tq, tk, tv, pos, window=window)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (B, H, D)
    assert K11.FWD_LAUNCHES == before
    _close(got, want, dtype)


MODEL_DECODE = [  # B, S, H, Kv, D, Dv, pos, window, ring, softcap, scale
    (2, 16, 4, 2, 16, 16, 5, None, False, 0.0, None),
    (2, 16, 4, 2, 16, 16, 23, None, True, 0.0, None),     # ring, wrapped
    (1, 12, 6, 3, 8, 8, 30, 7, True, 15.0, 0.2),          # ring, window, softcap, scale
    (1, 20, 4, 1, 16, 16, 13, 5, False, 0.0, None),       # window
    (1, 8, 2, 2, 16, 16, 20, None, False, 0.0, None),     # pos past the end
    (2, 1500, 2, 2, 16, 16, 1499, None, False, 0.0, None),  # the cross cache's length
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MODEL_DECODE, ids=str)
def test_flash_decode_plain_is_decode_attention(shape, dtype):
    B, S, H, Kv, D, Dv, pos, window, ring, cap, scale = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, H, D), (B, S, Kv, D), (B, S, Kv, Dv)], dtype,
                                         S * 7 + pos)
    want = jattn.decode_attention(jq, jk, jv, jnp.asarray(pos, jnp.int32), window=window,
                                  ring=ring, logit_softcap=cap, query_scale=scale)
    got = tattn.decode_attention(tq, tk, tv, torch.tensor(pos, dtype=torch.int32),
                                 window=window, ring=ring, logit_softcap=cap, query_scale=scale)
    _close(got, want, dtype)


def test_decode_with_no_valid_slot_gives_zero():
    (_, _, _), (tq, tk, tv) = _inputs([(1, 2, 8), (1, 4, 2, 8), (1, 4, 2, 8)], "float32", 3)
    out = K11.flash_decode(tq, tk, tv, -1)
    assert torch.equal(out, torch.zeros_like(out))


def test_wrappers_refuse_what_no_kernel_takes():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="do not agree"):
        K10.flash_attention(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        K10.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        K10.flash_attention(q, q.to("meta"), q)
    with pytest.raises(ValueError, match="several devices"):
        K11.flash_decode(q[:, 0], q, q, torch.zeros((), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("grad_mode,needs", [(True, "q"), (True, "k"), (True, "v"),
                                             (True, ""), (False, "qkv")])
def test_k10_grad_path_on_the_card_by_a_fixed_rule(grad_mode, needs):
    """On the card a call runs through ``K10Function`` (the forward with
    its log-sum-exp, then the backward kernel) exactly when autograd will
    differentiate it (grad mode on and an input requiring grad), by
    ``grad_path``; otherwise the forward alone. On the CPU the plain
    version runs either way, and its autograd gradients equal the plain
    backward's (``ref.flash_attention_bwd_ref``, the kernel's equations)
    within 1e-5: two fp32 orders of the same sums."""
    q, k, v = (torch.randn(1, 6, 2, 8, generator=torch.Generator().manual_seed(i),
                           requires_grad=name in needs) for i, name in enumerate("qkv"))
    kw = dict(causal=True, q_offset=-2)  # rows 0 and 1 see no key (F5)
    with torch.set_grad_enabled(grad_mode):
        path = K10.grad_path(q, k, v)
        launches = (K10.FWD_LAUNCHES, K10.BWD_LAUNCHES)
        out = K10.flash_attention(q, k, v, **kw)
    assert path == (grad_mode and needs != "")
    assert (K10.FWD_LAUNCHES, K10.BWD_LAUNCHES) == launches  # the plain version is no launch
    assert out.requires_grad == path
    if not path:
        return
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    wanted = [t for t in (q, k, v) if t.requires_grad]
    got = torch.autograd.grad(out, wanted, do)
    o, lse = K10.flash_attention_fwd_lse(q.detach(), k.detach(), v.detach(), **kw)
    assert torch.isinf(lse[0, :, :2]).all() and torch.isfinite(lse[0, :, 2:]).all()
    ref_grads = dict(zip("qkv", K10.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                                        o, lse, do, **kw)))
    for name, g in zip([n for n in "qkv" if n in needs], got):
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), atol=1e-5, rtol=1e-5)
    assert torch.equal(ref_grads["q"][0, :2], torch.zeros_like(ref_grads["q"][0, :2]))


def test_one_term_bf16_p_would_not_match():
    """The hazard the tensor-core K10 avoids: P.V with p rounded to bf16
    once (what SDPA and FlashAttention do) computes another function than
    the reference's fp32 p. Against JAX's ``blockwise_attention`` at
    Whisper's 1,500 source frames, one term changes far more of the
    bf16-rounded outputs than p = p_hi + p_lo (two bf16 terms, the
    kernel's two register-A products)."""
    B, Sq, Sk, H, D = 1, 64, 1500, 4, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, Sq, H, D), (B, Sk, H, D), (B, Sk, H, D)],
                                         "bfloat16", 17)
    want = torch.from_numpy(_np(jattn.blockwise_attention(jq, jk, jv, causal=False)).copy())
    q, k, v = (t.double().permute(0, 2, 1, 3) for t in (tq, tk, tv))     # (B, H, S, D)
    s = (q @ k.transpose(-1, -2)) * D ** -0.5
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).float()              # fp32 p
    l = p.double().sum(dim=-1, keepdim=True)
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()

    def share_differing(pv):
        out = (pv.double() @ v / l).permute(0, 2, 1, 3).bfloat16().float()
        return float((out != want).double().mean())

    one_term, two_terms = share_differing(hi), share_differing(hi.double() + lo.double())
    assert one_term > 0.10, one_term
    assert two_terms <= 0.02, two_terms


def _split_decode(q, k_cache, v_cache, pos: int, *, window=None, ring=False, cap=0.0,
                  scale=None):
    """K11's split-S rule written out: each SPLIT_SLOTS-slot split's online
    softmax over its valid slots (a split with none gives the neutral
    partial m = -1e30, l = 0, acc = 0), then the merge in split order,
    o = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30), M
    guarded as m_safe. fp32 throughout."""
    B, H, D = q.shape
    S, Kv, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    G = H // Kv
    scale = D ** -0.5 if scale is None else scale
    qf = q.float().reshape(B, Kv, G, D) * scale
    neg = ref.NEG_INF
    parts = []
    for sp in range(K11.n_splits(S)):
        lo, hi = sp * K11.SPLIT_SLOTS, min(S, (sp + 1) * K11.SPLIT_SLOTS) - 1
        if not ring:
            hi = min(hi, pos)
            if window:
                lo = max(lo, pos - window + 1)
        if lo > hi:
            parts.append((torch.full((B, Kv, G), neg), torch.zeros(B, Kv, G),
                          torch.zeros(B, Kv, G, Dv)))
            continue
        j = torch.arange(lo, hi + 1)
        a = pos - torch.remainder(pos - j, S) if ring else j
        valid = (a >= 0) & (a <= pos)
        if window:
            valid &= a > pos - window
        s = torch.einsum("bkgd,bjkd->bkgj", qf, k_cache[:, lo:hi + 1].float())
        if cap > 0:
            s = cap * torch.tanh(s / cap)
        s = torch.where(valid, s, neg)
        m = s.amax(dim=-1)
        m_safe = torch.where(m <= neg / 2, 0.0, m)
        p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgj,bjkd->bkgd", p, v_cache[:, lo:hi + 1].float())))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    M_safe = torch.where(M <= neg / 2, 0.0, M)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:  # in split order
        w = torch.where(m <= neg / 2, 0.0, torch.exp(m - M_safe))
        L = L + w * l
        A = A + w[..., None] * acc
    return (A / torch.clamp(L, min=1e-30)[..., None]).reshape(B, H, Dv)


SPLIT_CASES = [  # splits, B, H, Kv, D, pos, window, ring, softcap, scale
    (1, 2, 4, 4, 16, "S-1", None, False, 0.0, None),
    (3, 2, 4, 4, 16, "S-1", None, False, 0.0, None),
    (3, 1, 4, 4, 16, "SPLIT", None, False, 0.0, None),     # a split edge at pos, a dead split
    (3, 1, 4, 4, 16, "SPLIT-1", None, False, 0.0, None),
    (3, 2, 8, 2, 16, 1000, 90, True, 20.0, 0.3),            # ring, window, softcap, G = 4
    (3, 1, 4, 1, 8, 70, 30, False, 10.0, None),             # a window inside split 1, G = 4
    (3, 2, 4, 2, 16, -1, None, False, 0.0, None),           # no valid slot: 0
    ("n", 1, 2, 2, 16, "S-1", None, False, 0.0, None),      # the cross cache's 1,500 slots
    ("n", 1, 2, 2, 16, 700, None, False, 0.0, None),        # its later splits dead
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_decode_rule_is_decode_attention(case):
    splits, B, H, Kv, D, pos, window, ring, cap, scale = case
    S = {1: K11.SPLIT_SLOTS, 3: 3 * K11.SPLIT_SLOTS - 5, "n": 1500}[splits]
    pos = {"S-1": S - 1, "SPLIT": K11.SPLIT_SLOTS, "SPLIT-1": K11.SPLIT_SLOTS - 1}.get(pos, pos)
    assert K11.n_splits(S) == (splits if splits != "n" else -(-1500 // K11.SPLIT_SLOTS))
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, H, D), (B, S, Kv, D), (B, S, Kv, D)], "float32",
                                         S + H + D)
    want = jattn.decode_attention(jq, jk, jv, jnp.asarray(pos, jnp.int32), window=window,
                                  ring=ring, logit_softcap=cap, query_scale=scale)
    got = _split_decode(tq, tk, tv, pos, window=window, ring=ring, cap=cap, scale=scale)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    if pos < 0:
        assert torch.equal(got, torch.zeros_like(got))


ROUTES = [  # dtype, D, Dv, route
    (torch.bfloat16, 64, 64, "wgmma"),
    (torch.bfloat16, 16, 16, "wgmma"),
    (torch.bfloat16, 96, 80, "wgmma"),
    (torch.bfloat16, 128, 128, "wgmma"),
    (torch.bfloat16, 24, 24, "simt"),
    (torch.bfloat16, 64, 40, "simt"),
    (torch.float32, 64, 64, "simt"),
]


@pytest.mark.parametrize("dtype,D,Dv,want", ROUTES, ids=str)
def test_k10_route_is_a_fixed_rule(dtype, D, Dv, want):
    """bf16 with D and Dv multiples of 16 (16-byte aligned) takes the
    tensor cores; fp32 and other widths the CUDA cores."""
    q, k = torch.zeros(1, 4, 2, D, dtype=dtype), torch.zeros(1, 4, 2, D, dtype=dtype)
    v = torch.zeros(1, 4, 2, Dv, dtype=dtype)
    assert K10.route(q, k, v) == want
    if want == "wgmma":  # a view 2 bytes into its storage is not aligned
        flat = torch.zeros(q.numel() + 1, dtype=dtype)
        assert K10.route(flat[1:].view(q.shape), k, v) == "simt"


BWD_ROUTES = [  # dtype, D, Dv, which input is made misaligned or non-contiguous, route
    (torch.bfloat16, 64, 64, None, "wgmma"),
    (torch.bfloat16, 128, 128, None, "wgmma"),
    (torch.bfloat16, 64, 48, None, "wgmma"),
    (torch.bfloat16, 16, 16, None, "wgmma"),
    (torch.bfloat16, 24, 24, None, "simt"),
    (torch.bfloat16, 64, 40, None, "simt"),
    (torch.float32, 64, 64, None, "simt"),
    (torch.bfloat16, 64, 64, "misaligned q", "simt"),
    (torch.bfloat16, 64, 64, "misaligned o", "simt"),
    (torch.bfloat16, 64, 64, "non-contiguous do", "simt"),
    (torch.bfloat16, 64, 64, "non-contiguous k", "simt"),
]


@pytest.mark.parametrize("dtype,D,Dv,fault,want", BWD_ROUTES, ids=str)
def test_k10_bwd_route_is_a_fixed_rule(dtype, D, Dv, fault, want):
    """The backward's rule: bf16 with D and Dv multiples of 16 and q, k, v,
    o and do contiguous and 16-byte aligned take the tensor cores; fp32,
    other widths, and any input misaligned or not contiguous the CUDA
    cores."""
    B, S, H, Kv = 1, 4, 2, 2
    shapes = {"q": (B, S, H, D), "k": (B, S, Kv, D), "v": (B, S, Kv, Dv), "o": (B, S, H, Dv),
              "do": (B, S, H, Dv)}
    ts = {n: torch.zeros(sh, dtype=dtype) for n, sh in shapes.items()}
    if fault is not None:
        kind, name = fault.split()
        sh = shapes[name]
        if kind == "misaligned":  # a view 2 bytes into its storage
            flat = torch.zeros(int(np.prod(sh)) + 1, dtype=dtype)
            ts[name] = flat[1:].view(sh)
        else:  # the same shape, heads and rows swapped in memory
            ts[name] = torch.zeros(sh[0], sh[2], sh[1], sh[3], dtype=dtype).transpose(1, 2)
        assert ts[name].data_ptr() % 16 != 0 or not ts[name].is_contiguous()
    assert K10.bwd_route(*ts.values()) == want


# ------------------------------------------------------------------ layers

def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_positions_match_jax(dtype):
    (jx, js, jb), (tx, ts, tb) = _inputs([(2, 5, 3, 16), (16,), (16,)], dtype, 11)
    _close(tlayers.layer_norm(tx, ts, tb), jlayers.layer_norm(jx, js, jb), dtype)
    _close(tlayers.rms_norm(tx, ts), jlayers.rms_norm(jx, js), dtype)
    _close(tlayers.rms_norm(tx, ts, plus_one=True), jlayers.rms_norm(jx, js, plus_one=True),
           dtype)
    pos = np.random.default_rng(2).integers(0, 500, size=(2, 5))
    _close(tlayers.apply_rope(tx, torch.from_numpy(pos), 1e4),
           jlayers.apply_rope(jx, jnp.asarray(pos), 1e4), dtype)
    np.testing.assert_allclose(tlayers.sinusoidal_positions(37, 24).numpy(),
                               _np(jlayers.sinusoidal_positions(37, 24)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "silu", "relu"])
@pytest.mark.parametrize("gated", [False, True])
def test_mlp_matches_jax(act, gated):
    """The reference's "gelu" is ``jax.nn.gelu``'s default, the tanh form."""
    p = jlayers.mlp_init(jax.random.PRNGKey(3), 16, 40, gated=gated)
    (jx,), (tx,) = _inputs([(3, 4, 16)], "float32", 4)
    want = jlayers.mlp_apply(p, jx * 3.0, act)
    got = tlayers.mlp_apply(params_from_jax(jax.tree.map(np.asarray, p)), tx * 3.0, act)
    _close(got, want, "float32")


def test_exact_gelu_would_not_match():
    """The hazard: PyTorch's default gelu is the exact erf form."""
    x = torch.linspace(-4, 4, 101)
    want = _np(jax.nn.gelu(jnp.asarray(x.numpy())))
    assert np.abs(torch.nn.functional.gelu(x).numpy() - want).max() > 1e-4
    _close(tlayers._ACTS["gelu"](x), want, "float32")


@pytest.mark.parametrize("S,chunk", [(12, 4), (12, 5), (7, 64), (16, 8)])
@pytest.mark.parametrize("weighted", [False, True])
def test_lm_loss_matches_jax(S, chunk, weighted):
    rng = np.random.default_rng(S * chunk)
    h = rng.standard_normal((3, S, 16)).astype(np.float32)
    un = rng.standard_normal((16, 50)).astype(np.float32)
    tok = rng.integers(0, 50, size=(3, S))
    w = np.array([1.0, 0.0, 2.0], np.float32) if weighted else None
    want = jlayers.lm_loss(jnp.asarray(h), jnp.asarray(un), jnp.asarray(tok), chunk=chunk,
                           weight=None if w is None else jnp.asarray(w))
    got = tlayers.lm_loss(torch.from_numpy(h), torch.from_numpy(un), torch.from_numpy(tok),
                          chunk=chunk, weight=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ------------------------------------------------------------------ attn layer

ATTN_CFGS = [
    dict(d_model=32, n_heads=4, n_kv=2, head_dim=8),
    dict(d_model=32, n_heads=4, n_kv=4, head_dim=8, rope_theta=0.0, causal=False),
    dict(d_model=24, n_heads=6, n_kv=3, head_dim=8, qk_norm=True, use_bias=True, window=5,
         logit_softcap=10.0, query_scale=0.3),
]


@pytest.mark.parametrize("kw", ATTN_CFGS, ids=str)
def test_attn_forward_and_decode_match_jax(kw):
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    jp = jax.tree.map(np.asarray, jattn.attn_init(jax.random.PRNGKey(1), jcfg))
    if kw.get("use_bias"):  # non-zero biases and norm scales, so they show
        rng = np.random.default_rng(0)
        jp = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.3
                  if v.ndim == 1 else v) for k, v in jp.items()}
    tp = params_from_jax(jp)
    (jx,), (tx,) = _inputs([(2, 9, kw["d_model"])], "float32", 6)
    jout, (jk, jv) = jattn.attn_forward(jp, jcfg, jx, block_kv=4)
    tout, (tk, tv) = tattn.attn_forward(tp, tcfg, tx, block_kv=4)
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    # one decode step at pos 9 on a cache holding the 9 tokens, then a ring
    S = 12
    for ring, pos in ((False, 9), (True, 14)):
        jkc = jnp.zeros((2, S, jcfg.n_kv, jcfg.head_dim)).at[:, :9].set(jk)
        jvc = jnp.zeros((2, S, jcfg.n_kv, jcfg.head_dim)).at[:, :9].set(jv)
        tkc, tvc = torch.from_numpy(np.array(jkc)), torch.from_numpy(np.array(jvc))
        (jx1,), (tx1,) = _inputs([(2, 1, kw["d_model"])], "float32", pos)
        jo, jkc2, jvc2 = jattn.attn_decode(jp, jcfg, jx1, jkc, jvc,
                                           jnp.asarray(pos, jnp.int32), ring=ring)
        to, tkc2, tvc2 = tattn.attn_decode(tp, tcfg, tx1, tkc, tvc, pos, ring=ring)
        for got, want in ((to, jo), (tkc2, jkc2), (tvc2, jvc2)):
            np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
