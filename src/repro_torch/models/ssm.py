"""Mamba2 (state-space duality) block: the zamba2 substrate.

The port of ``repro/models/ssm.py``: the recurrence with a scalar decay
per head,

    h_t = exp(A dt_t) h_{t-1} + dt_t (x_t ⊗ B_t)      h: (P, N)
    y_t = h_t C_t + D x_t

with a depthwise causal conv over (x, B, C), softplus dt (the reference's
``logaddexp(x, 0)``: ``F.softplus`` switches to x above 20) and a gated
RMSNorm before the out-projection. ``mamba_forward`` runs the recurrence
on K13 (``kernels/ssm_scan.py``), one launch a layer, differentiated by
K13's backward under autograd; ``mamba_step`` runs the same kernel at
S = 1 from the cache's state. ``mamba_forward_chunked`` is the chunked
SSD form (``:161-221``), matrix-shaped, in plain PyTorch as the reference
computes it outside Pallas. Projections are stored per segment (z, x, BC,
dt), as in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.layers import dense_init, rms_norm


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int = 0         # default 2 x d_model
    headdim: int = 64        # P
    d_state: int = 64        # N
    conv_width: int = 4

    def __post_init__(self):
        if self.d_inner == 0:
            object.__setattr__(self, "d_inner", 2 * self.d_model)

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.headdim == 0
        return self.d_inner // self.headdim


def mamba_init(generator: torch.Generator, cfg: MambaConfig,
               dtype: torch.dtype = torch.float32, device=None) -> dict:
    """One block's parameters (``repro/models/ssm.py:44``): the reference's
    initializers and keys, drawn from ``generator``."""
    H, N, d_in = cfg.n_heads, cfg.d_state, cfg.d_inner
    dev = generator.device if device is None else device

    def dense(d_i, d_o):
        return dense_init(generator, d_i, d_o, dtype, device=dev)

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.1).to(dtype)

    return {
        "in_z": dense(cfg.d_model, d_in),
        "in_x": dense(cfg.d_model, d_in),
        "in_bc": dense(cfg.d_model, 2 * N),
        "in_dt": dense(cfg.d_model, H),
        "conv_x_w": normal(cfg.conv_width, d_in),
        "conv_x_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "conv_bc_w": normal(cfg.conv_width, 2 * N),
        "conv_bc_b": torch.zeros((2 * N,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=dev),
        # dt ~ 0.05 at init (softplus^-1), the Mamba2 convention
        "dt_bias": torch.full((H,), math.log(math.expm1(0.05)), dtype=dtype, device=dev),
        "norm": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": dense(d_in, cfg.d_model),
    }


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no switch to x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _conv(w, b, x, conv_state=None):
    """Depthwise causal conv of width W then silu, x (B, S, C). Returns
    (out, the new left context (B, W-1, C): the last W-1 pre-conv
    inputs)."""
    W = w.shape[0]
    if conv_state is None:
        xp = torch.cat([torch.zeros_like(x[:, :W - 1]), x], dim=1)
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    wx = w.to(x.dtype)
    out = sum(xp[:, i:i + x.shape[1]] * wx[i] for i in range(W))
    return F.silu(out + b.to(x.dtype)), xp[:, -(W - 1):]


def _project(p: dict, cfg: MambaConfig, x, conv_states=None):
    """x (B, S, D) -> z, xin (B, S, H, P), Bc, Cc (B, S, N), dt (B, S, H)
    fp32, and the new conv states."""
    B, S, _ = x.shape
    H, P, N = cfg.n_heads, cfg.headdim, cfg.d_state
    z = x @ p["in_z"].to(x.dtype)
    xi = x @ p["in_x"].to(x.dtype)
    bc = x @ p["in_bc"].to(x.dtype)
    dt = x @ p["in_dt"].to(x.dtype)
    xi, ns_x = _conv(p["conv_x_w"], p["conv_x_b"], xi,
                     None if conv_states is None else conv_states["x"])
    bc, ns_bc = _conv(p["conv_bc_w"], p["conv_bc_b"], bc,
                      None if conv_states is None else conv_states["bc"])
    xin = xi.reshape(B, S, H, P)
    Bc, Cc = bc[..., :N], bc[..., N:]
    dt = softplus(dt.float() + p["dt_bias"].float())
    return z, xin, Bc, Cc, dt, {"x": ns_x, "bc": ns_bc}


def _gate_out(p: dict, cfg: MambaConfig, x, y, xin, z):
    """The D skip, the gated RMSNorm and the out-projection: y (B, S, H, P)
    fp32 -> (B, S, D) in x's dtype."""
    B, S = x.shape[:2]
    y = y + p["D"].float()[None, None, :, None] * xin.float()
    y = y.reshape(B, S, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"].to(x.dtype)


def mamba_forward(p: dict, cfg: MambaConfig, x):
    """The full-sequence training forward, x (B, S, D) -> (B, S, D): the
    recurrence from a zero state on K13."""
    z, xin, Bc, Cc, dt, _ = _project(p, cfg, x)
    A = -torch.exp(p["A_log"].float())                          # (H,)
    decay = torch.exp(dt * A)                                   # (B, S, H)
    y, _ = ssm_scan(xin.float(), dt, decay, Bc.float(), Cc.float())
    return _gate_out(p, cfg, x, y, xin, z)


def mamba_init_state(cfg: MambaConfig, batch: int, dtype: torch.dtype = torch.float32,
                     device="cuda") -> dict:
    """A zero decode state: the SSM state fp32, the conv contexts in
    ``dtype``."""
    H, P, N, W = cfg.n_heads, cfg.headdim, cfg.d_state, cfg.conv_width
    return {"ssm": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
            "conv": {"x": torch.zeros((batch, W - 1, cfg.d_inner), dtype=dtype, device=device),
                     "bc": torch.zeros((batch, W - 1, 2 * N), dtype=dtype, device=device)}}


def mamba_step(p: dict, cfg: MambaConfig, x, state: dict):
    """The one-token decode step, x (B, 1, D), state from
    ``mamba_init_state``: K13 at S = 1 from the state. Returns (out (B, 1,
    D), new state)."""
    z, xin, Bc, Cc, dt, conv_state = _project(p, cfg, x, conv_states=state["conv"])
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)                                   # (B, 1, H)
    y, h = ssm_scan(xin.float(), dt, decay, Bc.float(), Cc.float(), state["ssm"])
    out = _gate_out(p, cfg, x, y, xin, z)
    new_conv = {k: v.to(state["conv"][k].dtype) for k, v in conv_state.items()}
    return out, {"ssm": h, "conv": new_conv}


def mamba_forward_chunked(p: dict, cfg: MambaConfig, x, chunk: int = 128):
    """The chunked SSD forward (the reference's matrix-shaped form of the
    same recurrence): within a chunk of Q tokens, y_t = C_t·(decay_t
    h_in) + Σ_{τ≤t} Γ[t, τ] dt_τ (C_t·B_τ) x_τ + D x_t with Γ[t, τ] =
    exp(La_t - La_τ), the cumulative log-decays; the state passes from
    chunk to chunk. Plain PyTorch, fp32 inside."""
    B, S, D = x.shape
    H, P, N = cfg.n_heads, cfg.headdim, cfg.d_state
    z, xin, Bc, Cc, dt, _ = _project(p, cfg, x)
    A = -torch.exp(p["A_log"].float())
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    xf, Bf, Cf = xin.float(), Bc.float(), Cc.float()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        xq, Bq, Cq, dtq = xf[:, c0:c0 + Q], Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q], \
            dt[:, c0:c0 + Q]
        la = torch.cumsum(dtq * A, dim=1)                       # (B, Q, H)
        cb = torch.einsum("btn,bqn->btq", Cq, Bq)               # (B, Q, Q)
        gamma = torch.exp(la[:, :, None, :] - la[:, None, :, :])  # (B, Q, Q, H)
        gamma = torch.where(tri[None, :, :, None], gamma, 0.0)
        scores = cb[..., None] * gamma * dtq[:, None, :, :]     # (B, t, tau, H)
        y = torch.einsum("btqh,bqhp->bthp", scores, xq)
        y = y + torch.einsum("bqh,bhpn,bqn->bqhp", torch.exp(la), h, Cq)
        wts = torch.exp(la[:, -1:, :] - la) * dtq               # (B, Q, H)
        h = h * torch.exp(la[:, -1])[..., None, None] \
            + torch.einsum("bqh,bqhp,bqn->bhpn", wts, xq, Bq)
        ys.append(y)
    return _gate_out(p, cfg, x, torch.cat(ys, dim=1), xin, z)
