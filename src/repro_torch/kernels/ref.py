"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function is what a hand-written kernel in ``repro_torch.kernels``
computes, written as ordinary tensor code. A wrapper takes it for a
tensor on the CPU, and ``chip_smoke.py`` holds each kernel against it on
the card. ``rnnt_joint_ref`` is the dense joint oracle the tests use.
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


def rnnt_joint_ref(enc_proj, pred_proj, w_out, bias, labels):
    """Dense joint oracle: materializes (B, T, U1, V) logits.

    enc_proj (B, T, J); pred_proj (B, U1, J); w_out (J, V); bias (V,);
    labels (B, U1) label ids (the last is unused). Returns (blank_lp,
    label_lp), each (B, T, U1) fp32."""
    h = torch.tanh(enc_proj[:, :, None, :].float() + pred_proj[:, None, :, :].float())
    logits = h @ w_out.float() + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.long()[:, None, :, None].expand(*logits.shape[:3], 1)
    label_lp = torch.gather(logits, -1, idx)[..., 0] - lse
    return logits[..., 0] - lse, label_lp
