"""Parameter initializers, drawn from an explicit ``torch.Generator``,
the time loops of the recurrent layers, and the transformer layers.

The initializers are the port's counterparts of
``repro/models/layers.py:21-27``: the same distributions and scales, in
the JAX layout (``x @ w``, w of shape (d_in, d_out)). The draws differ
from JAX's; tests that compare the two packages carry JAX's weights
across with ``repro_torch.convert``. ``scan`` and ``chunked_scan`` are
the counterparts of ``lax.scan`` and ``repro/models/layers.py:155-176``.
The norms, rope, positions, MLP and LM loss are those of
``repro/models/layers.py:38-152``, with the same dtype rules: norms and
the loss's logits in fp32, the result cast back to the input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import tanh
from torch.utils.checkpoint import checkpoint


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32, scale: float | None = None, device=None):
    """``device`` None: the generator's (``"meta"`` gives the shapes alone)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device if device is None else device)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32, scale: float = 1.0, device=None):
    w = torch.randn((vocab, d), generator=generator,
                    device=generator.device if device is None else device)
    return (w * (scale / math.sqrt(d))).to(dtype)


def scan(body, carry, xs):
    """``lax.scan`` as a Python loop: body(carry, x_t) -> (carry, y_t)
    over the leading axis of xs. Returns (carry, ys stacked on axis 0)."""
    ys = []
    for x in xs:
        carry, y = body(carry, x)
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(body, carry, xs, chunk: int):
    """``scan`` over checkpointed chunks of ``chunk`` steps: the backward
    keeps only each chunk's initial carry and recomputes its steps, the
    memory fix for long recurrences. As in the reference, a length that
    ``chunk`` does not divide, or that is at most ``chunk``, is one plain
    scan, and so is ``chunk`` 0. The carry is a tuple of tensors."""
    S = xs.shape[0]
    if not chunk or S % chunk or S <= chunk:
        return scan(body, carry, xs)

    def run(xc, *c):
        c, ys = scan(body, c, xc)
        return (*c, ys)

    ys = []
    for xc in xs.split(chunk):
        *carry, y = checkpoint(run, xc, *carry, use_reentrant=False)
        ys.append(y)
    return tuple(carry), torch.cat(ys)


# ---------------------------------------------------------------- norms

def rms_norm(x, scale, eps: float = 1e-6, plus_one: bool = False):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    s = scale.float()
    if plus_one:  # gemma convention
        s = 1.0 + s
    return (x * s).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """fp32 inside, cast back: ``repro/models/layers.py:49``."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def apply_rope(x, positions, theta: float = 10000.0):
    """x (..., S, H, D) or (..., S, D); positions (..., S) integers.
    Split-half convention: pairs (x[..., :D/2], x[..., D/2:])."""
    d = x.shape[-1]
    ang = positions[..., None].float() * rope_freqs(d, theta, x.device)
    if x.dim() == ang.dim() + 1:  # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(length: int, d: int, device=None):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------- mlp

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, gated: bool = True,
             dtype: torch.dtype = torch.float32, device=None) -> dict:
    p = {"w_up": dense_init(generator, d_model, d_ff, dtype, device=device),
         "w_down": dense_init(generator, d_ff, d_model, dtype, device=device)}
    if gated:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype, device=device)
    return p


# ``jax.nn.gelu`` is the tanh form by default, so the reference's "gelu"
# is too: the exact erf form would not match it
_ACTS = {"silu": F.silu, "gelu": lambda v: F.gelu(v, approximate="tanh"),
         "gelu_tanh": lambda v: F.gelu(v, approximate="tanh"), "relu": F.relu}


def mlp_apply(p: dict, x, act: str = "silu"):
    actf = _ACTS[act]
    up = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        up = actf(x @ p["w_gate"].to(x.dtype)) * up
    else:
        up = actf(up)
    return up @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------- losses

def chunked_softmax_xent(h, unembed, targets, mask=None, chunk: int = 256,
                         logit_softcap: float = 0.0):
    """Next-token CE without the (B, S, V) logits: h (B, S, D), unembed
    (D, V), targets (B, S), mask (B, S). Chunks of S as the reference's
    scan cuts them (the largest divisor of S near ``chunk``); each
    chunk's logits are fp32 and transient. Returns (sum_loss, sum_mask)."""
    B, S, _ = h.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    n_chunks = max(1, S // chunk)
    while S % n_chunks:
        n_chunks -= 1
    c = S // n_chunks
    w = unembed.to(h.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        hh, tt, mm = h[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c], \
            mask[:, i * c:(i + 1) * c]
        logits = (hh @ w).float()
        if logit_softcap > 0:
            logits = logit_softcap * tanh(logits / logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tt[..., None].long())[..., 0]
        tot = tot + ((lse - gold) * mm).sum()
        cnt = cnt + mm.sum()
    return tot, cnt


def lm_loss(h, unembed, tokens, chunk: int = 256, logit_softcap: float = 0.0, weight=None):
    """Shifted next-token loss over (B, S) tokens given the final hidden
    h; ``weight`` optional per-example (B,) (0 = a padding example)."""
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if weight is not None:
        mask = mask * weight[:, None].float()
    tot, cnt = chunked_softmax_xent(h, unembed, targets, mask, chunk, logit_softcap)
    return tot / torch.clamp(cnt, min=1.0)
