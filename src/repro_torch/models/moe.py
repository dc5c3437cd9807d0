"""Mixture-of-Experts FFN: top-k routing, capacity-bounded sort-based
dispatch, the shared experts and the Switch load-balance aux loss.

The port of ``repro/models/moe.py``. Dispatch is sort-based and per batch
row, as in the reference (which vmaps it over B; here the row is the
leading axis of every index tensor): each row sorts its (token, choice)
pairs by expert id, stably, and writes them into a static (E, C, D)
capacity buffer; a pair past its expert's capacity goes to slot E·C,
which the reference's ``mode="drop"`` scatter drops. Here the buffer has
E·C + 1 rows and the last one is cut off, and the combine reads that slot
as 0 (the reference's ``mode="fill"`` gather) from a zero row appended to
the expert outputs. The expert products are plain batched products
(``torch.einsum`` over the (B, E, C, D) buffer), computed outside any
Pallas kernel in the reference too.

Routing must agree between the card and the CPU: ``jax.lax.top_k``
breaks ties toward the lower expert index, and ``torch.topk`` promises no
order on CUDA, so the top k come from a stable descending sort.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import _ACTS, dense_init, mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0            # dense "shared experts" (DeepSeek-V2 style)
    shared_ff: int = 0           # hidden dim of the shared-expert MLP
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    renormalize: bool = True     # renormalize the top-k gates to sum to 1


def moe_init(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32, device=None) -> dict:
    """The reference's initializers (``repro/models/moe.py:36-49``); the
    router is kept in fp32."""
    dev = generator.device if device is None else device
    E, F = cfg.n_experts, cfg.expert_ff
    scale = d_model ** -0.5

    def normal(shape, s):
        return (torch.randn(shape, generator=generator, device=dev) * s).to(dtype)

    p = {"router": dense_init(generator, d_model, E, torch.float32, device=dev),
         "w_gate": normal((E, d_model, F), scale),
         "w_up": normal((E, d_model, F), scale),
         "w_down": normal((E, F, d_model), F ** -0.5)}
    if cfg.n_shared > 0:
        shared_ff = cfg.shared_ff or cfg.n_shared * cfg.expert_ff
        p["shared"] = mlp_init(generator, d_model, shared_ff, gated=True, dtype=dtype,
                               device=dev)
    return p


def capacity(cfg: MoEConfig, S: int) -> int:
    """Slots an expert a row: ``repro/models/moe.py:92-93``, the same
    Python arithmetic."""
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * S * K / E))
    return min(C, S * K)


def _route(logits: torch.Tensor, cfg: MoEConfig):
    """(probs, gate values, expert ids) from the router's fp32 logits; the
    top k by a stable descending sort (ties to the lower index, as
    ``jax.lax.top_k``)."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    if cfg.renormalize:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def _dispatch_row(xt, gate_vals, expert_idx, E: int, C: int):
    """Rows of tokens: xt (B, S, D), gate_vals and expert_idx (B, S, K).
    Returns (buf (B, E, C, D), slot, keep, tok, gate), each (B, S·K) in the
    row's expert-sorted order; slot E·C marks a dropped pair."""
    B, S, D = xt.shape
    K = expert_idx.shape[-1]
    flat_e = expert_idx.reshape(B, S * K)
    flat_g = gate_vals.reshape(B, S * K)
    flat_t = (torch.arange(S * K, device=xt.device) // K).expand(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se, st, sg = (torch.gather(a, 1, order) for a in (flat_e, flat_t, flat_g))
    counts = torch.zeros((B, E), dtype=torch.long, device=xt.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_e = torch.arange(S * K, device=xt.device) - torch.gather(starts, 1, se)
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + torch.clamp(pos_in_e, 0, C - 1),
                       torch.full_like(se, E * C))
    rows = torch.arange(B, device=xt.device)[:, None]
    # kept slots are distinct; every dropped pair lands in the extra row
    buf = xt.new_zeros((B, E * C + 1, D))
    buf = buf.index_put((rows.expand(B, S * K), slot), xt[rows, st])
    return buf[:, :E * C].reshape(B, E, C, D), slot, keep, st, sg


def _combine_row(eout, slot, keep, st, sg, S: int):
    """eout (B, E, C, D) -> out (B, S, D): each kept slot's output, gated,
    added back to its token. The add starts from 0 and a token gets at
    most top_k terms: with top_k <= 2 any order gives the same sum (the
    card's scatter-add uses atomics); with top_k > 2 the card's sum can
    differ from the CPU's by rounding."""
    B, E, C, D = eout.shape
    flat = torch.cat([eout.reshape(B, E * C, D), eout.new_zeros((B, 1, D))], dim=1)
    rows = torch.arange(B, device=eout.device)[:, None]
    vals = flat[rows, slot]
    w = (sg * keep.to(sg.dtype))[..., None].to(vals.dtype)
    out = eout.new_zeros((B, S, D))
    return out.scatter_add(1, st[..., None].expand(B, st.shape[1], D), vals * w)


def moe_apply(p: dict, cfg: MoEConfig, x, act: str = "silu"):
    """x (B, S, D) -> (out (B, S, D), aux loss scalar fp32)."""
    B, S, D = x.shape
    E = cfg.n_experts
    C = capacity(cfg, S)

    logits = (x.float() @ p["router"]).float()                          # (B, S, E)
    probs, gate_vals, expert_idx = _route(logits, cfg)
    buf, slot, keep, st, sg = _dispatch_row(x, gate_vals, expert_idx, E, C)

    actf = _ACTS[act]
    g = torch.einsum("becd,edf->becf", buf, p["w_gate"].to(x.dtype))
    u = torch.einsum("becd,edf->becf", buf, p["w_up"].to(x.dtype))
    eout = torch.einsum("becf,efd->becd", actf(g) * u, p["w_down"].to(x.dtype))
    out = _combine_row(eout, slot, keep, st, sg, S)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    top1 = torch.nn.functional.one_hot(expert_idx[..., 0], E).float()
    frac_tokens = top1.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = cfg.aux_loss_weight * E * torch.sum(frac_tokens * frac_probs)

    if cfg.n_shared > 0:
        out = out + mlp_apply(p["shared"], x, act)
    return out, aux
