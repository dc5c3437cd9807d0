"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function is what a hand-written kernel in ``repro_torch.kernels``
computes, written as ordinary tensor code. A wrapper takes it for a
tensor on the CPU, and ``chip_smoke.py`` holds each kernel against it on
the card.

The scan's plain versions (K2) work time-major, (S, B, ...), as the TPU
kernels do. The joint's plain versions (K3/K4) work one chunk of U at a
time, so on the CPU they never hold the (B, T, U1, V) logits, only
(B, T, c, V).

The compression plane's plain versions (K5-K9) take a leading client
axis, (K, n), as the kernels do. The threefry hash is restated as int64
operations masked to 32 bits, since PyTorch's unsigned 32-bit type has
few operators; its words are held bitwise to ``jax.random``.
"""

from __future__ import annotations

import math
import threading

import torch


# ATen's CPU tanh is MKL VML's, run on the intra-op (OpenMP) threads in
# chunks of _VML_GRAIN elements. In fresh processes under load its first
# use gave one chunk wrong by up to 8.8e-5 (about EP accuracy, where ATen
# asks for HA) in about 1 process in 125, and every later call was exact;
# one call on every intra-op thread first removed it. ``tanh`` makes that
# call once for each calling thread, thread count and dtype before its
# first use of the path.
_VML_GRAIN = 2048
_TANH_WARM: set = set()


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``torch.tanh``; on the CPU, after every intra-op thread of the
    caller's pool has run it once."""
    if x.device.type == "cpu":
        key = (threading.get_ident(), torch.get_num_threads(), x.dtype)
        if key not in _TANH_WARM:
            torch.tanh(torch.zeros(2 * _VML_GRAIN * key[1], dtype=x.dtype))
            _TANH_WARM.add(key)
    return torch.tanh(x)


def _math_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 math for fp32 and bf16 inputs (the kernels' contract); fp64
    stays fp64 so that gradcheck can run on the plain version."""
    return torch.promote_types(dtype, torch.float32)


def _activations(gates: torch.Tensor):
    H = gates.shape[-1] // 4
    gi, gf, gg, go = gates.to(_math_dtype(gates.dtype)).split(H, dim=-1)
    return torch.sigmoid(gi), torch.sigmoid(gf + 1.0), tanh(gg), torch.sigmoid(go)


def lstm_gates_ref(gates: torch.Tensor, c: torch.Tensor):
    """gates (N, 4H) pre-activations [i|f|g|o] with +1 on the forget
    gate; c (N, H). Returns (h_new in the gate dtype, c_new in c's dtype)."""
    i, f, g, o = _activations(gates)
    c_new = f * c.to(i.dtype) + i * g
    h_new = o * tanh(c_new)
    return h_new.to(gates.dtype), c_new.to(c.dtype)


def lstm_gates_bwd_ref(gates, c, dh, dc_next):
    """Backward of ``lstm_gates_ref`` from the saved (gates, c), written
    out as the formula of the TPU backward kernel
    (``repro/kernels/lstm_gates.py:74-89``). Returns (dgates (N, 4H) in
    the gate dtype, dc_prev (N, H) in c's dtype)."""
    i, f, g, o = _activations(gates)
    cf = c.to(i.dtype)
    dh = dh.to(i.dtype)
    t = tanh(f * cf + i * g)
    dc = dc_next.to(i.dtype) + dh * o * (1.0 - t * t)
    dgates = torch.cat(
        [dc * g * i * (1.0 - i), dc * cf * f * (1.0 - f), dc * i * (1.0 - g * g),
         dh * t * o * (1.0 - o)],
        dim=-1,
    )
    return dgates.to(gates.dtype), (dc * f).to(c.dtype)


def lstm_scan_ref(xg, w_hh, h0, c0):
    """The whole recurrence (K2), time-major, as the TPU kernel computes
    it (``repro/kernels/lstm_gates.py:178-199``). xg (S, B, 4H) the
    hoisted input pre-activations, w_hh (H, 4H), h0 and c0 (B, H).
    Gates ``xg + h @ w_hh`` in fp32 with w_hh uncast; the h carry stays
    fp32 across steps. Returns (ys (S, B, H) in xg's dtype, cs (S, B, H)
    fp32); fp64 passes through."""
    dt = _math_dtype(xg.dtype)
    w = w_hh.to(dt)
    h, c = h0.to(dt), c0.to(dt)
    ys, cs = [], []
    for t in range(xg.shape[0]):
        i, f, g, o = _activations(xg[t].to(dt) + h @ w)
        c = f * c + i * g
        h = o * tanh(c)
        ys.append(h.to(xg.dtype))
        cs.append(c)
    return torch.stack(ys), torch.stack(cs)


def _h_prev(h0, ys, dt):
    """The step-t predecessor of every step: h0 at t=0, the stored ys[t-1]
    after, in the math dtype (S, B, H)."""
    return torch.cat([h0[None].to(dt), ys[:-1].to(dt)])


def lstm_scan_bwd_gates_ref(xg, w_hh, h0, ys):
    """The backward recurrence's gates, recomputed for every step at once:
    the activations [i|f|g|o] of ``xg + h_prev @ w_hh`` (S, B, 4H), with
    h_prev as in the backward recurrence; fp32 (fp64 for fp64)."""
    dt = _math_dtype(xg.dtype)
    return torch.cat(_activations(xg.to(dt) + _h_prev(h0, ys, dt) @ w_hh.to(dt)), dim=-1)


def lstm_scan_bwd_rec_ref(xg, w_hh, h0, c0, ys, cs, dys, dhT, dcT):
    """The backward recurrence of K2, t = S-1..0, from the saved (ys, cs)
    as ``repro/kernels/lstm_gates.py:235-292`` does: h_prev is the stored
    ys[t-1] (bf16 at paper width), h0/c0 at t=0, and the gates are
    recomputed. Returns (dxg (S, B, 4H), dh0, dc0), all fp32 (fp64 for
    fp64 inputs)."""
    dt = _math_dtype(xg.dtype)
    w = w_hh.to(dt)
    h_prev = _h_prev(h0, ys, dt)
    c_prev = torch.cat([c0[None].to(dt), cs[:-1].to(dt)])
    dh, dc = dhT.to(dt), dcT.to(dt)
    dxg = torch.empty(xg.shape, dtype=dt, device=xg.device)
    for t in reversed(range(xg.shape[0])):
        i, f, g, o = _activations(xg[t].to(dt) + h_prev[t] @ w)
        tct = tanh(f * c_prev[t] + i * g)
        dh = dh + dys[t].to(dt)
        dc = dc + dh * o * (1.0 - tct * tct)
        dg = torch.cat([dc * g * i * (1.0 - i), dc * c_prev[t] * f * (1.0 - f),
                        dc * i * (1.0 - g * g), dh * tct * o * (1.0 - o)], dim=-1)
        dxg[t] = dg
        dh = dg @ w.T
        dc = dc * f
    return dxg, dh, dc


def lstm_scan_dw_ref(h0, ys, dgates):
    """dw_hh (H, 4H) = the sum over steps and rows of h_prevᵀ dgates,
    with h_prev as in the backward recurrence; fp32 (fp64 for fp64)."""
    dt = _math_dtype(dgates.dtype)
    H = ys.shape[-1]
    return _h_prev(h0, ys, dt).reshape(-1, H).T @ dgates.to(dt).reshape(-1, 4 * H)


def lstm_scan_bwd_ref(xg, w_hh, h0, c0, ys, cs, dys, dhT, dcT):
    """The whole K2 backward: (dxg, dw_hh, dh0, dc0), fp32 (fp64 for fp64)."""
    dxg, dh0, dc0 = lstm_scan_bwd_rec_ref(xg, w_hh, h0, c0, ys, cs, dys, dhT, dcT)
    return dxg, lstm_scan_dw_ref(h0, ys, dxg), dh0, dc0


def _joint_chunks(e, g, w, b, labels, u_chunk: int):
    """Yield (u0, h, logits, lbl) per chunk of at most ``u_chunk``
    positions of U1: h = tanh(e + g) (B, T, c, J) and the logits
    (B, T, c, V), in the math dtype."""
    dt = _math_dtype(e.dtype)
    e, w, b = e.to(dt), w.to(dt), b.to(dt)
    for u0 in range(0, g.shape[1], u_chunk):
        g_c = g[:, u0:u0 + u_chunk].to(dt)
        h = tanh(e[:, :, None, :] + g_c[:, None, :, :])
        yield u0, h, h @ w + b, labels[:, u0:u0 + u_chunk].long()


def _dlogits(logits, lse, dblank, dlabel, lbl):
    """The softmax cotangent of ``repro/kernels/rnnt_joint.py:148-172``:
    dblank·[v=0] + dlabel·[v=label] − (dblank+dlabel)·exp(logits − lse)."""
    dt = logits.dtype
    dbl, dlb = dblank.to(dt)[..., None], dlabel.to(dt)[..., None]
    d = -(dbl + dlb) * torch.exp(logits - lse.to(dt)[..., None])
    d[..., :1] += dbl
    idx = lbl[:, None, :, None].expand(*logits.shape[:3], 1)
    return d.scatter_add(-1, idx, dlb)


# K3's launches on the card, one plain version each: h (rnnt_joint_h_ref,
# below, K4's first launch too), the (B, T, U1, V) logits, then their
# log-sum-exp in the kernel's order.

LSE_SLAB = 128  # K3's log-sum-exp slab (kTV in csrc/rnnt_joint.cu): 32 lanes x 4 columns


def _exp32(x):
    """exp of fp32 values, taken in fp64 and rounded once to fp32: a
    fixed rounding (the card's expf may differ from it by an ulp)."""
    return torch.exp(x.double()).float()


def _fma32(a, b, c):
    """fmaf(a, b, c) of fp32 tensors: the product is exact in fp64, the
    sum rounded there, then to fp32."""
    return (a.double() * b.double() + c.double()).float()


def _lane_xor_sum(x):
    """The warp's xor-tree sum over the last axis of 32 lanes: at each of
    the strides 16, 8, 4, 2, 1 a lane adds its partner's value to its own
    (every lane ends with the same bits)."""
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., lane ^ o]
    return x[..., 0]


def rnnt_joint_logits_ref(h, w, b):
    """The logits (B, T, U1, V) = h @ w + b from h (B, T, U1, J)."""
    dt = h.dtype
    return h @ w.to(dt) + b.to(dt)


def rnnt_joint_lse_ref(logits, labels):
    """K3's log-sum-exp launch written out in its order: for each
    lattice point, V in ``LSE_SLAB``-column slabs in slab order; lane tx
    of 32 holds columns v0 + tx + 32c (c = 0..3, -inf past V); the slab's
    max; each lane's exponentials e^(x - m') summed in c order, then
    across the lanes by the xor tree; the running sum merged as
    fmaf(l, e^(m - m'), s); lse = m + log(max(l, 1e-30)). exp and log are
    ``_exp32``'s. logits (B, T, U1, V) fp32, labels (B, U1) -> (blank_lp,
    label_lp, lse), each (B, T, U1) fp32; a label outside [0, V) reads 0."""
    B, T, U1, V = logits.shape
    x = logits.float().reshape(-1, V)
    N, S = x.shape[0], -(-V // LSE_SLAB)
    pad = torch.full((N, S * LSE_SLAB - V), -torch.inf, device=x.device)
    slabs = torch.cat([x, pad], dim=1).reshape(N, S, LSE_SLAB // 32, 32)  # [n, slab, c, lane]
    m = torch.full((N,), -torch.inf, device=x.device)
    l = torch.zeros(N, device=x.device)
    for s in range(S):
        lg = slabs[:, s]
        nm = torch.maximum(m, lg.amax(dim=(1, 2)))
        e = _exp32(lg - nm[:, None, None])
        lane = e[:, 0]
        for c in range(1, LSE_SLAB // 32):
            lane = lane + e[:, c]
        l = _fma32(l, _exp32(m - nm), _lane_xor_sum(lane))
        m = nm
    lse = m + torch.log(torch.clamp(l, min=1e-30).double()).float()
    lbl = labels.long()[:, None, :].expand(B, T, U1).reshape(-1)
    ok = (lbl >= 0) & (lbl < V)
    at = torch.gather(x, 1, torch.where(ok, lbl, 0)[:, None])[:, 0]
    label = torch.where(ok, at, torch.zeros_like(at)) - lse
    return tuple(t.reshape(B, T, U1) for t in (x[:, 0] - lse, label, lse))


def rnnt_joint_fwd_ref(e, g, w, b, labels, u_chunk: int = 8):
    """The fused joint forward (K3). e (B, T, J), g (B, U1, J), w (J, V),
    b (V,), labels (B, U1) int (the last column unused). Returns
    (blank_lp, label_lp, lse), each (B, T, U1) in fp32 (fp64 for fp64
    inputs)."""
    blank, label, lse = [], [], []
    for _, _, logits, lbl in _joint_chunks(e, g, w, b, labels, u_chunk):
        s = torch.logsumexp(logits, dim=-1)
        idx = lbl[:, None, :, None].expand(*logits.shape[:3], 1)
        blank.append(logits[..., 0] - s)
        label.append(torch.gather(logits, -1, idx)[..., 0] - s)
        lse.append(s)
    return tuple(torch.cat(x, dim=2) for x in (blank, label, lse))


def rnnt_joint_bwd_dpre_ref(e, g, w, b, labels, lse, dblank, dlabel, u_chunk: int = 8):
    """The first part of K4: dpre (B, T, U1, J), the gradient at tanh's
    input. Per chunk, dh = dlogits @ w.T and dpre = dh·(1 − h²)."""
    dpre = []
    for u0, h, logits, lbl in _joint_chunks(e, g, w, b, labels, u_chunk):
        c = h.shape[2]
        d = _dlogits(logits, lse[:, :, u0:u0 + c], dblank[:, :, u0:u0 + c],
                     dlabel[:, :, u0:u0 + c], lbl)
        dpre.append((d @ w.to(d.dtype).T) * (1.0 - h * h))
    return torch.cat(dpre, dim=2)


def rnnt_joint_bwd_reduce_ref(dpre):
    """The second part of K4: (de (B, T, J), dg (B, U1, J)), the sums of
    dpre over U1 and over T."""
    return dpre.sum(dim=2), dpre.sum(dim=1)


def rnnt_joint_bwd_w_ref(e, g, w, b, labels, lse, dblank, dlabel, u_chunk: int = 8):
    """The part of K4 that gives (dw (J, V), db (V,)): per chunk,
    dw += h.T @ dlogits and db += the sum of dlogits."""
    dt = _math_dtype(e.dtype)
    dw = torch.zeros(w.shape, dtype=dt, device=w.device)
    db = torch.zeros(b.shape, dtype=dt, device=b.device)
    for u0, h, logits, lbl in _joint_chunks(e, g, w, b, labels, u_chunk):
        c = h.shape[2]
        d = _dlogits(logits, lse[:, :, u0:u0 + c], dblank[:, :, u0:u0 + c],
                     dlabel[:, :, u0:u0 + c], lbl)
        dw += h.reshape(-1, h.shape[-1]).T @ d.reshape(-1, d.shape[-1])
        db += d.sum(dim=(0, 1, 2))
    return dw, db


def rnnt_joint_bwd_ref(e, g, w, b, labels, lse, dblank, dlabel, u_chunk: int = 8):
    """The fused joint backward (K4), recomputed from the forward's lse:
    (de, dg, dw, db) in fp32 (fp64 for fp64 inputs)."""
    args = (e, g, w, b, labels, lse, dblank, dlabel, u_chunk)
    return (*rnnt_joint_bwd_reduce_ref(rnnt_joint_bwd_dpre_ref(*args)),
            *rnnt_joint_bwd_w_ref(*args))


# K4's launches on the card, one plain version each; they hold the whole
# (B, T, U1, V) dlogits, as the kernels do: h (K3's first launch too),
# dlogits, dpre, then rnnt_joint_bwd_reduce_ref, then dW and db.

def rnnt_joint_h_ref(e, g):
    """h = tanh(e + g) (B, T, U1, J) at every lattice point, in the math
    dtype."""
    dt = _math_dtype(e.dtype)
    return tanh(e.to(dt)[:, :, None, :] + g.to(dt)[:, None, :, :])


def rnnt_joint_dlogits_ref(h, w, b, labels, lse, dblank, dlabel):
    """The logits' cotangent (B, T, U1, V) from h (B, T, U1, J): the
    logits h @ w + b through ``_dlogits``."""
    dt = h.dtype
    return _dlogits(h @ w.to(dt) + b.to(dt), lse, dblank, dlabel, labels.long())


def rnnt_joint_dpre_ref(dlogits, w, h):
    """dpre = (dlogits @ wᵀ)·(1 − h²) (B, T, U1, J), the gradient at
    tanh's input."""
    return (dlogits @ w.to(dlogits.dtype).T) * (1.0 - h * h)


def rnnt_joint_dw_ref(h, dlogits):
    """(dw (J, V), db (V,)): hᵀ·dlogits and the sum of dlogits over every
    lattice point."""
    J, V = h.shape[-1], dlogits.shape[-1]
    d = dlogits.reshape(-1, V)
    return h.reshape(-1, J).T @ d, d.sum(dim=0)


# ----------------------------------------------------- compression plane
# The counterparts of repro/kernels/ref.py:76-131 and :204 (nibble pack,
# dequantize, quantize, top-k unpack, scatter-add) and :147-201 (the
# threefry2x32 hash behind the keyed stochastic rounding). Integers are int64 tensors (or Python ints) that
# hold 32-bit words in [0, 2**32).

_M32 = 0xFFFFFFFF
_THREEFRY_C = 0x1BD11BDA
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32_pair(k0, k1, c0, c1):
    """One threefry2x32 block: 32-bit key words and counter words (int64
    tensors or ints, broadcast together) -> both 32-bit output words, on
    jax's 20-round schedule."""
    ks2 = k0 ^ k1 ^ _THREEFRY_C
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    inject = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    for i, (i0, i1) in enumerate(inject):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + i0) & _M32
        x1 = (x1 + i1 + (i + 1)) & _M32
    return x0, x1


def threefry_random_bits_at(k0, k1, pos, n: int):
    """The 32-bit word at flat position(s) ``pos`` (int64) of a size-n
    draw, i.e. elementwise ``jax.random.bits(key, (n,))`` with the
    non-partitionable threefry: counters iota(n) split in halves, position
    p owning lane 0 of pair (p, p + half) when p < half, else lane 1 of
    pair (p - half, p), the odd tail's missing counter 0."""
    half = (n + 1) // 2
    lo = pos < half
    pair = torch.where(lo, pos, pos - half)
    c1 = pair + half
    c1 = torch.where(c1 < n, c1, torch.zeros_like(c1))
    o0, o1 = threefry2x32_pair(k0, k1, pair, c1)
    return torch.where(lo, o0, o1)


def bits_to_uniform(bits):
    """32-bit words (int64) -> [0, 1) float32 by jax.random.uniform's
    mantissa fill: the top 23 bits under the exponent of 1.0, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def threefry_bits_ref(k0, k1, n: int):
    """The n 32-bit words of ``jax.random.bits(key, (n,))`` (non-
    partitionable), each threefry block hashed once: block ``pair`` <
    half gives position pair its first word and position pair + half its
    second, the odd n's last second word dropped (its counter 0). Equal
    to ``threefry_random_bits_at`` at every position; K5 and the normal
    kernel pair positions this way (``csrc/threefry.cuh``)."""
    half = (n + 1) // 2
    device = k0.device if isinstance(k0, torch.Tensor) else None
    pair = torch.arange(half, dtype=torch.int64, device=device)
    c1 = pair + half
    o0, o1 = threefry2x32_pair(k0, k1, pair, torch.where(c1 < n, c1, torch.zeros_like(c1)))
    o0, o1 = torch.broadcast_tensors(o0, o1)
    return torch.cat([o0, o1], dim=-1)[..., :n]


def threefry_uniform_ref(key_data, n: int):
    """Key words (..., 2) in [0, 2**32) -> (..., n) float32, equal bit for
    bit to ``jax.random.uniform(key, (n,))`` for each key (with
    ``jax_threefry_partitionable`` off)."""
    kd = key_data.to(torch.int64)
    return bits_to_uniform(threefry_bits_ref(kd[..., 0:1], kd[..., 1:2], n))


# jax.random.normal in float32 (jax/_src/random.py ``_normal_real``):
# sqrt(2) * erf_inv(u), u uniform on [lo, 1) with lo the float32 after -1
# toward 0, i.e. max(lo, f * 2 + lo) from the [0, 1) fill f (the width
# 1 - lo rounds to 2 in float32). XLA lowers erf_inv to Giles's
# polynomial in w = -log1p(-x * x) (xla/hlo/builder/lib/math.cc ErfInv32)
# and its CPU backend emits log1p as Cephes's rational form for |y| <
# sqrt(2) - 1, else Eigen's float log of 1 + y, with every multiply-add
# whose product has no other use contracted to one fused multiply-add.
# The functions below restate that program operation by operation, as
# jax 0.9.0 compiles it on the CPU: each fused multiply-add is ``_fma32``
# (the product exact in fp64, one rounding of the sum there, then to fp32),
# the square root and the division are taken in fp64 and rounded once
# (both then correctly rounded; ATen's CPU float sqrt is not, on some
# inputs), every other operation is one IEEE float32 operation. Held over
# all 2**23 values the uniform can give: equal to jax.random.normal bit
# for bit, and the same bits with each ``_fma32`` taken as the correctly
# rounded fma (tests/test_torch_threefry_normal.py). Without the fused
# multiply-adds, or with a float64 log1p in place of XLA's, some values
# move by an ulp. csrc/threefry_normal.cu writes the same operations with
# fmaf, __fsqrt_rn and __fdiv_rn.
NORMAL_LO = -(1.0 - 2.0 ** -24)
_SQRT2_F32 = 1.4142135  # np.float32(np.sqrt(2))
_LOG1P_CEPHES_MAX = 0.41421357  # sqrt(2) - 1 in float32
_LOG1P_CEPHES_Q = (15.062909, 83.04757, 221.7624, 309.09872, 216.42789, 60.11866)
_LOG1P_CEPHES_P = (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967, 57.112965,
                   20.039553)
_LOG_SQRTHF = 0.70710677
_LOG_P = (0.070376836, -0.1151461, 0.116769984, -0.12420141, 0.14249323, -0.16668057,
          0.20000714, -0.24999994, 0.3333333)
_LOG_Q1, _LOG_Q2 = -0.00021219444, 0.693359375
_FLT_MIN = 1.1754944e-38
_ERF_INV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def xla_log1p_f32(y):
    """XLA's CPU log1p of float32 y: the normal's y = -x·x in (-1, 0], and
    the staleness discount's y = s >= 0 (held bit for bit to jnp.log1p on
    every float32 of [0, 2**16]). A subnormal y reads as 0, as XLA's CPU
    code reads it."""
    c = lambda v: _f32(v, y)  # noqa: E731
    one = c(1.0)
    y = torch.where(torch.abs(y) < c(_FLT_MIN), y * 0.0, y)
    # |y| < sqrt(2) - 1: y - y²/2 + y³ P(y)/Q(y)
    y2 = y * y
    q = y + c(_LOG1P_CEPHES_Q[0])
    for v in _LOG1P_CEPHES_Q[1:]:
        q = _fma32(q, y, c(v))
    p = _fma32(c(_LOG1P_CEPHES_P[0]), y, c(_LOG1P_CEPHES_P[1]))
    for v in _LOG1P_CEPHES_P[2:]:
        p = _fma32(p, y, c(v))
    r = (p.double() / q.double()).float()
    small = y + _fma32(y2, c(-0.5), (y * y2) * r)
    # otherwise Eigen's log of x = 1 + y: x = m 2^e, m in [sqrt(1/2), sqrt(2))
    x = y + one
    bits = torch.maximum(x, c(_FLT_MIN)).view(torch.int32)
    e = ((bits >> 23) - 127).float() + one
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    below = m < c(_LOG_SQRTHF)
    e = e - below.float()
    t = (m - one) + torch.where(below, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t
    a = _fma32(_fma32(t, c(_LOG_P[0]), c(_LOG_P[1])), t, c(_LOG_P[2]))
    b = _fma32(_fma32(t, c(_LOG_P[3]), c(_LOG_P[4])), t, c(_LOG_P[5]))
    d = _fma32(_fma32(t, c(_LOG_P[6]), c(_LOG_P[7])), t, c(_LOG_P[8]))
    poly = _fma32(_fma32(_fma32(a, t3, b), t3, d), t3, e * c(_LOG_Q1))
    large = _fma32(e, c(_LOG_Q2), (t - t2 * c(0.5)) + poly)
    large = torch.where(x == 0, c(-math.inf), large)
    large = torch.where(x < 0, c(math.nan), large)
    large = torch.where(x == math.inf, x, large)
    return torch.where(torch.abs(y) < c(_LOG1P_CEPHES_MAX), small, large)


# XLA's CPU exp of float32 (the Cephes polynomial of its vectorised
# exp): x clamped to [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to
# [-127, 127], r = x - n C1 - n C2, e^r by a degree-5 polynomial, times
# 2^n (0 at n = -127), a subnormal result flushed to 0 as XLA's CPU code
# flushes it. Every multiply-add is one fused multiply-add, as the
# compiled program has it. Held to jnp.exp bit for bit on every float32 of
# [-32, 32] (tests/test_torch_async_engine.py samples [-87.8, 88.7]).
_EXP_LO, _EXP_HI = -87.8, 88.8
_EXP_LOG2EF = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)


def xla_exp_f32(x):
    """XLA's CPU exp of float32 x, bit for bit."""
    c = lambda v: _f32(v, x)  # noqa: E731
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma32(x, c(_EXP_LOG2EF), c(0.5))), -127.0, 127.0)
    r = _fma32(n, c(-_EXP_C1), x)
    r = _fma32(n, c(-_EXP_C2), r)
    z = _fma32(r, c(_EXP_P[0]), c(_EXP_P[1]))
    for v in _EXP_P[2:]:
        z = _fma32(z, r, c(v))
    z = c(1.0) + _fma32(z, r * r, r)
    ni = n.to(torch.int32)
    pow2 = torch.where(ni > -127, ((ni + 127) << 23).view(torch.float32), c(0.0))
    out = z * pow2
    return torch.where(out < c(_FLT_MIN), c(0.0), out)


def xla_erf_inv_f32(x):
    """XLA's float32 ErfInv: w = -log1p(-x·x); below 5, w - 2.5 and the
    first 9 coefficients, else sqrt(w) - 3 and the other 9, in Horner
    form with fused multiply-adds; then p · x (±inf at x = ±1)."""
    return erf_inv_from_log1p(x, xla_log1p_f32(x * -x))


def erf_inv_from_log1p(x, lg):
    """XLA's ErfInv32 of x after its log1p: ``lg`` = log1p(-x·x) = -w."""
    c = lambda v: _f32(v, x)  # noqa: E731
    lt = lg > c(-5.0)
    w = torch.where(lt, c(-2.5) - lg, torch.sqrt((-lg).double()).float() - c(3.0))
    coef = lambda i: torch.where(lt, c(_ERF_INV_W_LT5[i]), c(_ERF_INV_W_GE5[i]))  # noqa: E731
    p = _fma32(coef(0), w, coef(1))
    for i in range(2, 9):
        p = _fma32(w, p, coef(i))
    p = torch.where(torch.abs(x) == 1.0, c(math.inf), p)
    return x * p


def uniform_to_normal(f, scale: float = 1.0):
    """[0, 1) float32 fills -> jax.random.normal's float32 values times
    ``scale``, as XLA compiles ``scale * normal`` with ``scale`` a
    constant: the two constants folded into one float32, (scale · √2) ·
    erf_inv(u). At scale 1 (or any power of 2) that is the normal times
    the scale; otherwise it can differ from it by an ulp."""
    lo = _f32(NORMAL_LO, f)
    u = torch.maximum(lo, _fma32(f, _f32(2.0, f), lo))
    return (_f32(scale, f) * _f32(_SQRT2_F32, f)) * xla_erf_inv_f32(u)


def threefry_normal_ref(key_data, n: int):
    """Key words (..., 2) -> (..., n) float32, equal bit for bit to
    ``jax.random.normal(key, (n,))`` for each key (non-partitionable
    threefry, jax 0.9.0's CPU program)."""
    return uniform_to_normal(threefry_uniform_ref(key_data, n))


def normal_axpy_ref(xs, key_data, scales):
    """The normal kernel's plain version: for each leaf i,
    (x_i.float() + scales[i] · normal(key_data[i], x_i.numel())).to(x_i.dtype),
    the product and then the sum as two IEEE float32 operations (JAX's
    ``p.astype(f32) + sigma * normal``). ``scales[i]`` is a float, a
    0-dim tensor, or a (K,) tensor whose entry k scales the k-th of K
    equal slices of the flattened leaf (the gaussian adversary's per-
    client RMS)."""
    out = []
    for x, kd, s in zip(xs, key_data, scales):
        z = threefry_normal_ref(kd.to(x.device), x.numel())
        s = torch.as_tensor(s, dtype=torch.float32).to(x.device)
        if s.dim() == 1:
            z = z.reshape(s.shape[0], -1)
            s = s[:, None]
        out.append((x.float().reshape(z.shape) + s * z).reshape(x.shape).to(x.dtype))
    return out


def nibble_pack_ref(codes):
    """int4 wire packing: (..., n) int8 codes in [-8, 7] -> (...,
    (n+1)//2) int8, element 2i in the low nibble and 2i+1 in the high one
    of a two's-complement byte; an odd n pads the last high nibble with 0."""
    c = codes.to(torch.int32) & 0xF
    if c.shape[-1] % 2:
        c = torch.nn.functional.pad(c, (0, 1))
    pairs = c.reshape(*c.shape[:-1], -1, 2)
    b = pairs[..., 0] | (pairs[..., 1] << 4)
    return (((b & 0xFF) ^ 0x80) - 0x80).to(torch.int8)


def nibble_unpack_ref(packed, n: int):
    """Inverse of ``nibble_pack_ref``: both nibbles of each byte sign
    extended, the odd-n pad dropped -> (..., n) int8."""
    b = packed.to(torch.int32) & 0xFF
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*b.shape[:-1], -1)[..., :n].to(torch.int8)


def _row_scale(scale, x):
    """The scale as an fp32 tensor on x's device that broadcasts over x
    (..., n): one value for every row, or (K,) one for each row of a
    (K, n) x. A tensor, so that a division by it is IEEE on the card too
    (PyTorch's CUDA division by a Python number or a CPU scalar multiplies
    by its reciprocal)."""
    s = torch.as_tensor(scale, dtype=torch.float32).to(x.device)
    return s[:, None] if s.dim() == 1 else s


def quantize_codes_with_scale_ref(x, scale, u, levels: float):
    """Codes against a given scale, one for all rows or (K,) one a row:
    y = clip(x / scale, ±levels) (the clamp before the draw), then
    floor(y) + [u < y - floor(y)] with the uniforms u, or round half to
    even when ``u`` is None -> int8 codes shaped like x."""
    s = _row_scale(scale, x)
    y = torch.clamp(x.float() / s, -levels, levels)
    if u is None:
        return torch.round(y).to(torch.int8)
    lo = torch.floor(y)
    return (lo + (u < (y - lo)).float()).to(torch.int8)


def quantize_pack_ref(x, scale, u, bits: int):
    """One intN wire buffer per row of x (..., n), against one scale or
    one a row: the int8 codes, or for int4 their nibble-packed bytes."""
    levels = 2.0 ** (bits - 1) - 1.0
    codes = quantize_codes_with_scale_ref(x, scale, u, levels)
    return nibble_pack_ref(codes) if bits == 4 else codes


def topk_scatter_add_ref(values, idx, weights, n: int):
    """The weighted scatter-add of stacked top-k payloads: values (K, k)
    fp32, idx (K, k) int flat indices, weights (K,) -> dense (n,) fp32.
    Clients are added one after another, so an index that several
    clients picked sums in client order from 0, as the reference's serial
    scatter does; within a client's row the indices are distinct (a
    top-k selection), so each add touches one element once. Indices
    outside [0, n) are dropped (a top-k selection never gives one; JAX's
    ``.at[].add`` would wrap a negative one)."""
    out = torch.zeros(n + 1, dtype=torch.float32, device=values.device)  # n: the dropped
    vals = weights.float()[:, None] * values.float()
    at = torch.where((idx >= 0) & (idx < n), idx.long(), n)
    for k in range(values.shape[0]):
        out.index_add_(0, at[k], vals[k])
    return out[:n]


def dequantize_ref(codes, scale):
    """The uplink dequantization (``repro/kernels/ref.py:97``) over a
    client axis: codes (K, n) int8 times the scale, one for all clients
    or (K,) one each -> (K, n) fp32, one IEEE product an element."""
    return codes.float() * _row_scale(scale, codes)


def topk_unpack_ref(values, idx, n: int):
    """The top-k payloads (``repro/kernels/ref.py:129``) over a client
    axis: values (K, k) fp32 at flat indices idx (K, k) -> (K, n) fp32,
    zero where no index points. Where a row names an index twice, the
    pair last in payload order wins, as the TPU kernels' serial loop and
    walk of the stably sorted payload do (``repro/kernels/wire_pack.py:
    340-349``, ``:366-384``): the payload is sorted by index with a stable
    sort and the last of each run of equal indices is written, each
    element once. Indices outside [0, n) are dropped."""
    K = values.shape[0]
    si, order = torch.sort(idx.long(), dim=1, stable=True)
    sv = torch.gather(values.float(), 1, order)
    last = torch.ones_like(si, dtype=torch.bool)
    last[:, :-1] = si[:, 1:] != si[:, :-1]
    keep = last & (si >= 0) & (si < n)
    rows = torch.arange(K, device=si.device)[:, None].expand_as(si)
    out = torch.zeros((K, n), dtype=torch.float32, device=values.device)
    out[rows[keep], si[keep]] = sv[keep]
    return out


# ------------------------------------------------------------------ attention
# K10 and K11's plain versions: the model's jnp functions
# (``repro/models/attention.py:84-205``), all arithmetic in fp32, the
# result in q's dtype. A query row with no valid key gives 0.

NEG_INF = -1.0e30


def attention_block_kv(Sk: int, block_kv: int = 512) -> int:
    """The reference's kv block: the largest divisor of Sk at or below
    ``block_kv``."""
    b = min(block_kv, Sk)
    while Sk % b:
        b -= 1
    return b


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        logit_softcap: float = 0.0, q_offset: int = 0,
                        scale=None, block_kv: int = 512, return_lse: bool = False):
    """q (B, Sq, H, D), k (B, Sk, Kv, D), v (B, Sk, Kv, Dv) -> (B, Sq, H,
    Dv) in q's dtype: ``blockwise_attention``'s online softmax over kv
    blocks, with its guards for a row whose keys are all masked
    (``m_safe``, ``corr``). Query i sits at ``q_offset + i``; ``window``
    None (or 0) is no window; ``scale`` None is D**-0.5. GQA: head h reads
    kv head h // (H / Kv). With ``return_lse``, (out, lse): the rows'
    log-sum-exp (B, H, Sq) fp32, m_safe + log(l), +inf for a row with no
    valid key (what the kernel's forward writes for its backward)."""
    B, Sq, H, D = q.shape
    Sk, Kv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Kv
    scale = D ** -0.5 if scale is None else scale
    qf = q.float().permute(0, 2, 1, 3) * scale                             # (B, H, Sq, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)      # (B, H, Sk, D)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    bk = attention_block_kv(Sk, block_kv)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), device=q.device)
    for j0 in range(0, Sk, bk):
        k_pos = j0 + torch.arange(bk, device=q.device)
        s = qf @ kf[:, :, j0:j0 + bk].transpose(-1, -2)                  # (B, H, Sq, bk)
        if logit_softcap > 0:
            s = logit_softcap * tanh(s / logit_softcap)
        mask = torch.ones((Sq, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        dead = m <= NEG_INF / 2
        corr = torch.where(dead, 0.0, torch.exp(torch.where(dead, NEG_INF, m) - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vf[:, :, j0:j0 + bk]
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    if not return_lse:
        return out
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    lse = torch.where(l > 0, m_safe + torch.log(l), math.inf)
    return out, lse.detach()


def attention_mask(Sq: int, Sk: int, causal: bool, window, q_offset: int, device):
    """(Sq, Sk) bool: the keys each query row attends to."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True, window=None,
                            logit_softcap: float = 0.0, q_offset: int = 0, scale=None):
    """K10's backward, FlashAttention-2's equations in fp32 from (q, k, v,
    o, lse, do): P = exp(s - lse) on valid keys with s the (softcapped)
    scaled score, di = rowsum(do o), dV = Pᵀ dO, dS = P (dO Vᵀ - di), times
    1 - tanh² of the raw score under a softcap, dQ = scale dS K, dK = dSᵀ
    (scale q); GQA sums the G query heads of a kv head. Returns (dq, dk, dv)
    in q's, k's and v's dtypes. A row with no valid key (lse +inf) gets 0."""
    B, Sq, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = D ** -0.5 if scale is None else scale
    qf = q.float().permute(0, 2, 1, 3) * scale                             # (B, H, Sq, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)      # (B, H, Sk, D)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    dof = do.float().permute(0, 2, 1, 3)                                  # (B, H, Sq, Dv)
    raw = qf @ kf.transpose(-1, -2)                                       # (B, H, Sq, Sk)
    t = tanh(raw / logit_softcap) if logit_softcap > 0 else None
    s = logit_softcap * t if t is not None else raw
    mask = attention_mask(Sq, Sk, causal, window, q_offset, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    di = (dof * o.float().permute(0, 2, 1, 3)).sum(dim=-1)
    ds = p * (dof @ vf.transpose(-1, -2) - di[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf).reshape(B, Kv, G, Sk, D).sum(dim=2)
    dv = (p.transpose(-1, -2) @ dof).reshape(B, Kv, G, Sk, -1).sum(dim=2)
    return (dq.permute(0, 2, 1, 3).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def decode_valid(S: int, pos, *, window=None, ring: bool = False):
    """(S,) bool: the cache slots one query at ``pos`` attends to
    (``repro/models/attention.py:190-197``). ``ring``: slot j holds
    absolute position pos - ((pos - j) mod S)."""
    pos = torch.as_tensor(pos)
    j = torch.arange(S, device=pos.device)
    abs_pos = pos - torch.remainder(pos - j, S) if ring else j
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window:
        valid &= abs_pos > pos - window
    return valid


def decode_attention_ref(q, k_cache, v_cache, pos, *, window=None, ring: bool = False,
                         logit_softcap: float = 0.0, scale=None):
    """q (B, H, D), caches (B, S, Kv, D/Dv), pos an int or a 0-d integer
    tensor (the current token, already written) -> (B, H, Dv) in q's
    dtype: one softmax over the cache, the G = H / Kv query heads of a kv
    head together."""
    B, H, D = q.shape
    S, Kv, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    G = H // Kv
    scale = D ** -0.5 if scale is None else scale
    qf = q.float().reshape(B, Kv, G, D) * scale
    kf = k_cache.float().permute(0, 2, 3, 1)                           # (B, Kv, D, S)
    vf = v_cache.float().permute(0, 2, 1, 3)                           # (B, Kv, S, Dv)
    s = qf @ kf                                                        # (B, Kv, G, S)
    if logit_softcap > 0:
        s = logit_softcap * tanh(s / logit_softcap)
    valid = decode_valid(S, torch.as_tensor(pos, device=q.device), window=window, ring=ring)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    out = (p @ vf) / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(B, H, Dv).to(q.dtype)


# ------------------------------------------------------------------ recurrences
# K12 (WKV-6) and K13 (Mamba2's scan): the reference's scan steps
# (``repro/models/rwkv.py:126-131``, ``repro/models/ssm.py:110-116``), one
# step at a time over (B, S, H, ...) fp32 inputs. The forward keeps the
# state at the start of every ``chunk`` steps (the checkpoints, as the
# reference's 64-step checkpointed chunks); the backward replays each chunk
# from its checkpoint and walks it back, as the kernels do, so the plain
# backward is the kernels' algorithm written out.


def _n_chunks(S: int, chunk: int) -> int:
    return -(-S // chunk)


def wkv6_fwd_ref(r, k, v, w, u, S0=None, chunk: int = 64):
    """r, k, v, w (B, S, H, P), u (H, P), S0 (B, H, P, P) or None (zeros)
    -> (y (B, S, H, P), S_T (B, H, P, P), checkpoints (B, H, n, P, P)):
    y_t = r_t (S_{t-1} + diag(u) k_t v_tᵀ), S_t = diag(w_t) S_{t-1} + k_t
    v_tᵀ, the state's rows the key dim; the checkpoints are S at t = 0,
    chunk, 2·chunk, ..."""
    B, S, H, P = r.shape
    state = torch.zeros((B, H, P, P), dtype=r.dtype, device=r.device) if S0 is None else S0
    ys, ckpts = [], []
    for t in range(S):
        if t % chunk == 0:
            ckpts.append(state)
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]                      # (B, H, P, P)
        ys.append(torch.einsum("bhp,bhpq->bhq", r[:, t], state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state, torch.stack(ckpts, dim=2)


def wkv6_bwd_ref(r, k, v, w, u, ckpts, dy, dS_T=None, chunk: int = 64):
    """The gradients of ``wkv6_fwd_ref``'s (y, S_T) from its checkpoints:
    (dr, dk, dv, dw (B, S, H, P), du (H, P), dS0 (B, H, P, P)). With G the
    cotangent of S_t, walking back: dr = (S_{t-1} + diag(u) k vᵀ) dy, dk =
    G v + r u (dy·v), dv = Gᵀ k + (Σ r u k) dy, dw = rowsum(G ∘ S_{t-1}),
    du += r k (dy·v), then G ← diag(w) G + r dyᵀ. du sums over the steps
    (last first) of each batch row, then over the rows in order."""
    B, S, H, P = r.shape
    G = torch.zeros((B, H, P, P), dtype=r.dtype, device=r.device) if dS_T is None else dS_T
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_rows = torch.zeros((B, H, P), dtype=r.dtype, device=r.device)
    for c in reversed(range(_n_chunks(S, chunk))):
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        states, state = [], ckpts[:, :, c]
        for t in range(t0, t1):
            states.append(state)
            state = w[:, t, :, :, None] * state + k[:, t, :, :, None] * v[:, t, :, None, :]
        for t in reversed(range(t0, t1)):
            prev = states[t - t0]
            r_t, k_t, v_t, w_t, dy_t = r[:, t], k[:, t], v[:, t], w[:, t], dy[:, t]
            dyv = (dy_t * v_t).sum(-1, keepdim=True)                       # (B, H, 1)
            kv = k_t[..., :, None] * v_t[..., None, :]
            dr[:, t] = torch.einsum("bhpq,bhq->bhp", prev + u[None, :, :, None] * kv, dy_t)
            dk[:, t] = torch.einsum("bhpq,bhq->bhp", G, v_t) + r_t * u * dyv
            rku = (r_t * u * k_t).sum(-1, keepdim=True)
            dv[:, t] = torch.einsum("bhpq,bhp->bhq", G, k_t) + rku * dy_t
            dw[:, t] = (G * prev).sum(-1)
            du_rows = du_rows + r_t * k_t * dyv
            G = w_t[..., :, None] * G + r_t[..., :, None] * dy_t[..., None, :]
    du = du_rows[0]
    for b in range(1, B):
        du = du + du_rows[b]
    return dr, dk, dv, dw, du, G


def ssm_scan_fwd_ref(x, dt, a, Bm, Cm, h0=None, chunk: int = 64):
    """x (B, S, H, P), dt and the decay a = exp(dt·A) (B, S, H), Bm, Cm
    (B, S, N), h0 (B, H, P, N) or None (zeros) -> (y (B, S, H, P), h_T,
    checkpoints (B, H, n, P, N)): h_t = a_t h_{t-1} + (dt_t x_t) ⊗ B_t,
    y_t = h_t C_t; the checkpoints are h at t = 0, chunk, ..."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device) if h0 is None else h0
    ys, ckpts = [], []
    for t in range(S):
        if t % chunk == 0:
            ckpts.append(h)
        h = h * a[:, t, :, None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h, torch.stack(ckpts, dim=2)


def ssm_scan_bwd_ref(x, dt, a, Bm, Cm, ckpts, dy, dh_T=None, chunk: int = 64):
    """The gradients of ``ssm_scan_fwd_ref``'s (y, h_T) from its
    checkpoints: (dx (B, S, H, P), ddt, da (B, S, H), dB, dC (B, S, N),
    dh0 (B, H, P, N)). With G the cotangent of h_t (dy_t ⊗ C_t added
    first), walking back: dC = Σ_h h_tᵀ dy, s = G B, dx = dt s, ddt = x·s,
    dB = Σ_h Gᵀ (dt x), da = Σ G ∘ h_{t-1}, then G ← a G. dB and dC sum
    the heads in order."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    G = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device) if dh_T is None else dh_T
    dx = torch.empty_like(x)
    ddt, da = torch.empty_like(dt), torch.empty_like(a)
    dB_heads = torch.empty((Bsz, S, H, N), dtype=x.dtype, device=x.device)
    dC_heads = torch.empty_like(dB_heads)
    for c in reversed(range(_n_chunks(S, chunk))):
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        states, h = [], ckpts[:, :, c]
        for t in range(t0, t1):
            states.append(h)
            h = h * a[:, t, :, None, None] \
                + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        for t in reversed(range(t0, t1)):
            prev = states[t - t0]
            xs = dt[:, t, :, None] * x[:, t]                                # (B, H, P)
            cur = prev * a[:, t, :, None, None] + xs[..., None] * Bm[:, t, None, None, :]
            dC_heads[:, t] = torch.einsum("bhpn,bhp->bhn", cur, dy[:, t])
            G = G + dy[:, t, :, :, None] * Cm[:, t, None, None, :]
            s = torch.einsum("bhpn,bn->bhp", G, Bm[:, t])
            dx[:, t] = dt[:, t, :, None] * s
            ddt[:, t] = (x[:, t] * s).sum(-1)
            dB_heads[:, t] = torch.einsum("bhpn,bhp->bhn", G, xs)
            da[:, t] = (G * prev).sum((-1, -2))
            G = a[:, t, :, None, None] * G
    dB, dC = dB_heads[:, :, 0], dC_heads[:, :, 0]
    for h in range(1, H):
        dB, dC = dB + dB_heads[:, :, h], dC + dC_heads[:, :, h]
    return dx, ddt, da, dB, dC, G
