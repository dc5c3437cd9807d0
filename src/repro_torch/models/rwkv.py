"""RWKV-6 "Finch" (arXiv:2404.05892): the attention-free layer with a
data-dependent per-channel decay.

The port of ``repro/models/rwkv.py``. Per head (key dim P -> value dim
P), with the decay w_t from a low-rank MLP of the token-shifted input:

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    y_t = r_t (S_{t-1} + diag(u) k_t v_tᵀ)

The recurrence runs on K12 (``kernels/wkv6.py``): one launch a layer over
the whole sequence, in training (a zero state, differentiated by K12's
backward under autograd), prefill and the one-token decode step (the
cache's state). The casts are the reference's: the LoRA decay in the
compute dtype, then ``exp(-exp(w0 + lora))`` in fp32; r, k, v and w enter
the recurrence in fp32, its state S stays fp32 and the token shift's
``last`` stays in the compute dtype; the layer and group norms compute in
fp32 and cast back. Token-shift mixing uses static per-channel
coefficients, as the reference's.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import tanh
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.layers import dense_init, layer_norm


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    head_size: int = 64
    d_ff: int = 0                # default 3.5 x d_model
    decay_lora: int = 64

    def __post_init__(self):
        if self.d_ff == 0:
            object.__setattr__(self, "d_ff", int(3.5 * self.d_model))

    @property
    def n_heads(self) -> int:
        assert self.d_model % self.head_size == 0
        return self.d_model // self.head_size


def rwkv_layer_init(generator: torch.Generator, cfg: RWKVConfig,
                    dtype: torch.dtype = torch.float32, device=None) -> dict:
    """One layer's parameters (``repro/models/rwkv.py:43``): the reference's
    initializers and keys, drawn from ``generator``."""
    D = cfg.d_model
    dev = generator.device if device is None else device

    def full(v):
        return torch.full((D,), v, dtype=dtype, device=dev)

    def dense(d_in, d_out, scale=None):
        return dense_init(generator, d_in, d_out, dtype, scale=scale, device=dev)

    p = {"ln1": full(1.0), "ln1_b": full(0.0), "ln2": full(1.0), "ln2_b": full(0.0),
         "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5), "mu_g": full(0.5),
         "mu_w": full(0.5)}
    for name in ("wr", "wk", "wv", "wg", "w_out"):
        p[name] = dense(D, D)
    p["w0"] = full(-6.0)
    p["wA"] = dense(D, cfg.decay_lora)
    p["wB"] = dense(cfg.decay_lora, D, scale=0.01)
    p["u"] = (torch.randn((D,), generator=generator, device=dev) * 0.1).to(dtype)
    p.update(gn_scale=full(1.0), gn_bias=full(0.0), mu_ck=full(0.5), mu_cr=full(0.5))
    p["ck"] = dense(D, cfg.d_ff)
    p["cv"] = dense(cfg.d_ff, D)
    p["cr"] = dense(D, D)
    return p


def _ln(x, s, b, eps: float = 1e-5):
    return layer_norm(x, s, b, eps)


def _group_norm(x, H: int, scale, bias, eps: float = 1e-5):
    """x (..., D) normalized over each of H groups, fp32 inside."""
    shp = x.shape
    xg = x.float().reshape(*shp[:-1], H, shp[-1] // H)
    mu = xg.mean(dim=-1, keepdim=True)
    var = (xg - mu).square().mean(dim=-1, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(shp) * scale.float() + bias.float()).to(x.dtype)


def _shift(x, last=None):
    """Token shift: the previous token at each position, x (B, S, D); the
    first position's is ``last`` (B, D), or zeros."""
    if last is None:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _decay(p: dict, xw):
    """The per-channel decay in (0, 1): exp(-exp(w0 + lora(xw))), the LoRA
    in the compute dtype, the rest in fp32."""
    lora = tanh(xw @ p["wA"].to(xw.dtype)) @ p["wB"].to(xw.dtype)
    logw = p["w0"].float() + lora.float()
    return torch.exp(-torch.exp(logw))


def _time_mix_inputs(p: dict, x, prev):
    def mix(mu):
        m = p[mu].to(x.dtype)
        return x * m + prev * (1 - m)

    return mix("mu_r"), mix("mu_k"), mix("mu_v"), mix("mu_g"), mix("mu_w")


def rwkv_time_mix(p: dict, cfg: RWKVConfig, x, state=None):
    """x (B, S, D); state {"last": (B, D), "S": (B, H, P, P)} or None
    (training). Returns (out, new state). The recurrence is K12."""
    B, S, D = x.shape
    H, P = cfg.n_heads, cfg.head_size
    xn = _ln(x, p["ln1"], p["ln1_b"])
    prev = _shift(xn, None if state is None else state["last"])
    xr, xk, xv, xg, xw = _time_mix_inputs(p, xn, prev)
    r = (xr @ p["wr"].to(x.dtype)).reshape(B, S, H, P)
    k = (xk @ p["wk"].to(x.dtype)).reshape(B, S, H, P)
    v = (xv @ p["wv"].to(x.dtype)).reshape(B, S, H, P)
    g = xg @ p["wg"].to(x.dtype)
    w = _decay(p, xw).reshape(B, S, H, P)
    u = p["u"].float().reshape(H, P)
    y, Sn = wkv6(r.float(), k.float(), v.float(), w, u,
                 None if state is None else state["S"])
    y = _group_norm(y.reshape(B, S, D).to(x.dtype), H, p["gn_scale"], p["gn_bias"])
    out = (y * F.silu(g)) @ p["w_out"].to(x.dtype)
    return out, {"last": xn[:, -1], "S": Sn}


def rwkv_channel_mix(p: dict, cfg: RWKVConfig, x, state=None):
    """state {"last": (B, D)} or None. Returns (out, new state)."""
    xn = _ln(x, p["ln2"], p["ln2_b"])
    prev = _shift(xn, None if state is None else state["last"])
    mk, mr = p["mu_ck"].to(x.dtype), p["mu_cr"].to(x.dtype)
    xk = xn * mk + prev * (1 - mk)
    xr = xn * mr + prev * (1 - mr)
    k = torch.square(F.relu(xk @ p["ck"].to(x.dtype)))
    out = torch.sigmoid(xr @ p["cr"].to(x.dtype)) * (k @ p["cv"].to(x.dtype))
    return out, {"last": xn[:, -1]}


def rwkv_layer_forward(p: dict, cfg: RWKVConfig, x, state=None):
    """The full layer (time mix, then channel mix, each residual). state:
    {"tm": ..., "cm": ...} or None. Returns (x, new state)."""
    a, tm_new = rwkv_time_mix(p, cfg, x, None if state is None else state["tm"])
    x = x + a
    b, cm_new = rwkv_channel_mix(p, cfg, x, None if state is None else state["cm"])
    return x + b, {"tm": tm_new, "cm": cm_new}


def rwkv_init_state(cfg: RWKVConfig, batch: int, dtype: torch.dtype = torch.float32,
                    device="cuda") -> dict:
    """A zero decode state: ``last`` in ``dtype``, S in fp32."""
    H, P, D = cfg.n_heads, cfg.head_size, cfg.d_model
    return {"tm": {"last": torch.zeros((batch, D), dtype=dtype, device=device),
                   "S": torch.zeros((batch, H, P, P), dtype=torch.float32, device=device)},
            "cm": {"last": torch.zeros((batch, D), dtype=dtype, device=device)}}
