"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function is what a hand-written kernel in ``repro_torch.kernels``
computes, written as ordinary tensor code. A wrapper takes it for a
tensor on the CPU, and ``chip_smoke.py`` holds each kernel against it on
the card.

The scan's plain versions (K2) work time-major, (S, B, ...), as the TPU
kernels do. The joint's plain versions (K3/K4) work one chunk of U at a
time, so on the CPU they never hold the (B, T, U1, V) logits, only
(B, T, c, V).
"""

from __future__ import annotations

import torch


def _math_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 math for fp32 and bf16 inputs (the kernels' contract); fp64
    stays fp64 so that gradcheck can run on the plain version."""
    return torch.promote_types(dtype, torch.float32)


def _activations(gates: torch.Tensor):
    H = gates.shape[-1] // 4
    gi, gf, gg, go = gates.to(_math_dtype(gates.dtype)).split(H, dim=-1)
    return torch.sigmoid(gi), torch.sigmoid(gf + 1.0), torch.tanh(gg), torch.sigmoid(go)


def lstm_gates_ref(gates: torch.Tensor, c: torch.Tensor):
    """gates (N, 4H) pre-activations [i|f|g|o] with +1 on the forget
    gate; c (N, H). Returns (h_new in the gate dtype, c_new in c's dtype)."""
    i, f, g, o = _activations(gates)
    c_new = f * c.to(i.dtype) + i * g
    h_new = o * torch.tanh(c_new)
    return h_new.to(gates.dtype), c_new.to(c.dtype)


def lstm_gates_bwd_ref(gates, c, dh, dc_next):
    """Backward of ``lstm_gates_ref`` from the saved (gates, c), written
    out as the formula of the TPU backward kernel
    (``repro/kernels/lstm_gates.py:74-89``). Returns (dgates (N, 4H) in
    the gate dtype, dc_prev (N, H) in c's dtype)."""
    i, f, g, o = _activations(gates)
    cf = c.to(i.dtype)
    dh = dh.to(i.dtype)
    t = torch.tanh(f * cf + i * g)
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
        h = o * torch.tanh(c)
        ys.append(h.to(xg.dtype))
        cs.append(c)
    return torch.stack(ys), torch.stack(cs)


def _h_prev(h0, ys, dt):
    """The step-t predecessor of every step: h0 at t=0, the stored ys[t-1]
    after, in the math dtype (S, B, H)."""
    return torch.cat([h0[None].to(dt), ys[:-1].to(dt)])


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
        tct = torch.tanh(f * c_prev[t] + i * g)
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
        h = torch.tanh(e[:, :, None, :] + g_c[:, None, :, :])
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
