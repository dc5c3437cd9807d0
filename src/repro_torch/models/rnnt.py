"""RNN-T, the paper's model (Fig. 1): LSTM audio encoder, LSTM label
encoder (prediction network), joint network, softmax over word-pieces.

The port of ``repro/models/rnnt.py:23-161``. ``RNNT`` is an
``nn.Module`` whose parameters carry the JAX names and layout
(``encoder.0.w_ih``, ``joint_out``, ...). It is built on the ``meta``
device by default: a shape-only template that the round engine calls
through ``torch.func.functional_call`` with explicit dicts of tensors
(``loss_fn``). ``init_params`` draws those dicts.

The joint computes only the (blank, label) log-probs the transducer DP
needs. With ``use_kernel=False`` (the default, as in JAX) it is
U-chunked as ``repro/kernels/ops.py:46-75`` does: the chunks are put
back in U order (the reference model's own flattening at
``repro/models/rnnt.py:120-121`` scrambles U once there are several
chunks). With ``use_kernel=True`` it goes through the fused joint
(``repro_torch.kernels.rnnt_joint``: K3 forward, K4 backward), with W
and b in the parameter dtype, as ``repro/models/rnnt.py:143-151`` does.

``greedy_decode`` is the transducer's greedy search
(``repro/models/rnnt.py:164-209``) on fixed shapes, with frames past
``frame_len // time_stride`` masked (ROADMAP F3: the reference masks
with the raw ``frame_len``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.asr.rnnt_loss import rnnt_loss_from_logprobs
from repro_torch.asr.specaugment import SpecAugmentConfig, spec_augment
from repro_torch.kernels.ref import tanh
from repro_torch.kernels.rnnt_joint import rnnt_joint
from repro_torch.models.layers import dense_init, embed_init
from repro_torch.models.lstm import (LSTMLayer, lstm_stack, lstm_stack_init_state,
                                     lstm_stack_step)


@dataclasses.dataclass(frozen=True)
class RNNTConfig:
    name: str = "rnnt"
    feat_dim: int = 128
    vocab: int = 4096              # word-pieces; id 0 = blank
    enc_layers: int = 8
    enc_hidden: int = 1152
    pred_layers: int = 2
    pred_hidden: int = 1152
    pred_embed: int = 512
    joint_dim: int = 640
    time_stride: int = 1           # frame subsampling before the encoder
    specaug: SpecAugmentConfig = dataclasses.field(default_factory=SpecAugmentConfig)
    dtype: str = "float32"
    param_dtype: str = "float32"
    use_kernel: bool = False       # fused joint kernels (K3/K4)
    scan_chunk: int = 0            # time-chunked checkpointed LSTM time loop (0: off)
    loss_norm: bool = True         # per-label-token NLL normalization

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def _joint_chunk(e, g, w, b, lbl):
    """(blank, label) log-probs of one U chunk: e (B, T, J), g (B, c, J),
    lbl (B, c) -> two (B, T, c) fp32."""
    h = tanh(e[:, :, None, :] + g[:, None, :, :])                 # (B, T, c, J)
    logits = (h @ w).float() + b                                   # (B, T, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    idx = lbl[:, None, :, None].expand(*logits.shape[:3], 1)
    return logits[..., 0] - lse, torch.gather(logits, -1, idx)[..., 0] - lse


class RNNT(nn.Module):
    def __init__(self, cfg: RNNTConfig, device="meta"):
        super().__init__()
        self.cfg = cfg
        dt, H, P = cfg.pdtype, cfg.enc_hidden, cfg.pred_hidden
        with torch.device(device):
            enc_in = cfg.feat_dim * cfg.time_stride
            self.encoder = nn.ModuleList(
                LSTMLayer(enc_in if i == 0 else H, H, dt) for i in range(cfg.enc_layers))
            self.pred_embed = nn.Parameter(torch.empty((cfg.vocab, cfg.pred_embed), dtype=dt))
            self.predictor = nn.ModuleList(
                LSTMLayer(cfg.pred_embed if i == 0 else P, P, dt) for i in range(cfg.pred_layers))
            self.joint_enc = nn.Parameter(torch.empty((H, cfg.joint_dim), dtype=dt))
            self.joint_pred = nn.Parameter(torch.empty((P, cfg.joint_dim), dtype=dt))
            self.joint_out = nn.Parameter(torch.empty((cfg.joint_dim, cfg.vocab), dtype=dt))
            self.joint_bias = nn.Parameter(torch.empty((cfg.vocab,), dtype=dt))

    def encode(self, features):
        """features (B, T, F) -> (B, T', enc_hidden)."""
        cfg = self.cfg
        x = features.to(cfg.cdtype)
        if cfg.time_stride > 1:
            B, T, Fd = x.shape
            T2 = T // cfg.time_stride
            x = x[:, : T2 * cfg.time_stride].reshape(B, T2, Fd * cfg.time_stride)
        return lstm_stack(self.encoder, x, chunk=cfg.scan_chunk)[0]

    def predict(self, labels):
        """labels (B, U) -> (B, U+1, pred_hidden); position 0 is the
        blank-start state (zero embedding)."""
        emb = self.pred_embed.to(self.cfg.cdtype)[labels.long()]          # (B, U, E)
        emb = torch.cat([torch.zeros_like(emb[:, :1]), emb], dim=1)
        return lstm_stack(self.predictor, emb, chunk=self.cfg.scan_chunk)[0]

    def joint_logprobs(self, enc, pred, labels, u_chunk: int = 8):
        """(blank_lp, label_lp), each (B, T, U1) fp32, never holding more
        than one U chunk of (B, T, c, V) logits; each chunk is
        recomputed in the backward, as ``jax.checkpoint`` does."""
        B, T, _ = enc.shape
        U1 = pred.shape[1]
        e = enc @ self.joint_enc.to(enc.dtype)                   # (B, T, J)
        g = pred @ self.joint_pred.to(pred.dtype)                # (B, U1, J)
        w = self.joint_out.to(enc.dtype)
        b = self.joint_bias.float()
        lbl = F.pad(labels.long(), (0, 1))                       # (B, U1)
        n_chunks = max(1, U1 // u_chunk)
        pad = (-U1) % n_chunks
        if pad:
            g = F.pad(g, (0, 0, 0, pad))
            lbl = F.pad(lbl, (0, pad))
        c = g.shape[1] // n_chunks
        outs = [checkpoint(_joint_chunk, e, g_i, w, b, l_i, use_reentrant=False)
                for g_i, l_i in zip(g.split(c, dim=1), lbl.split(c, dim=1))]
        # chunks concatenate in U order (F1 in ROADMAP: never interleave)
        blank_lp = torch.cat([o[0] for o in outs], dim=2)[:, :, :U1]
        label_lp = torch.cat([o[1] for o in outs], dim=2)[:, :, :U1]
        return blank_lp, label_lp

    def joint_fused(self, enc, pred, labels):
        """(blank_lp, label_lp) through the fused joint kernels (K3/K4),
        with W and b in the parameter dtype."""
        e = enc @ self.joint_enc.to(enc.dtype)                   # (B, T, J)
        g = pred @ self.joint_pred.to(pred.dtype)                # (B, U1, J)
        lbl = F.pad(labels, (0, 1)).to(torch.int32)              # (B, U1)
        return rnnt_joint(e, g, self.joint_out, self.joint_bias, lbl)

    def joint_logits(self, enc_t, pred_u):
        """Pointwise joint for decoding: enc_t (B, H), pred_u (B, P) ->
        (B, V) fp32 logits."""
        e = enc_t @ self.joint_enc.to(enc_t.dtype)
        g = pred_u @ self.joint_pred.to(pred_u.dtype)
        h = tanh(e + g)
        return (h @ self.joint_out.to(h.dtype)).float() + self.joint_bias.float()

    def greedy_decode(self, features, frame_len, max_symbols: int = 4):
        """Greedy transducer decode. Returns (B, T'·max_symbols) int32
        token ids, 0 = blank/pad. Every frame runs ``max_symbols``
        predictor steps and keeps their results only where a token was
        emitted, so nothing waits on the host."""
        cfg = self.cfg
        enc = self.encode(features)                                      # (B, T', H)
        B, T, _ = enc.shape
        device, cd = enc.device, cfg.cdtype
        weights = [(layer.w_ih.to(cd), layer.w_hh.to(cd), layer.b.to(cd))
                   for layer in self.predictor]
        embed = self.pred_embed.to(cd)
        state = lstm_stack_init_state(self.predictor, B, cd, device)
        g, state = lstm_stack_step(weights, torch.zeros((B, cfg.pred_embed), dtype=cd,
                                                        device=device), state)
        frames = torch.div(frame_len.to(device), cfg.time_stride, rounding_mode="floor")
        rows = torch.arange(B, device=device)
        out = torch.zeros((B, T * max_symbols), dtype=torch.int32, device=device)
        n_out = torch.zeros((B,), dtype=torch.long, device=device)

        def keep(mask, new, old):
            return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

        for t in range(T):
            g2, state2, out2, n_out2 = g, state, out.clone(), n_out
            done = torch.zeros((B,), dtype=torch.bool, device=device)
            for _ in range(max_symbols):
                tok = torch.argmax(self.joint_logits(enc[:, t], g2), dim=-1)     # (B,)
                emit = (tok != 0) & ~done
                g_new, state_new = lstm_stack_step(weights, embed[tok], state2)
                g2 = keep(emit, g_new, g2)
                state2 = [(keep(emit, hn, ho), keep(emit, cn, co))
                          for (hn, cn), (ho, co) in zip(state_new, state2)]
                out2[rows, n_out2] = torch.where(emit, tok.to(torch.int32), out2[rows, n_out2])
                n_out2 = n_out2 + emit.long()
                done = done | ~emit
            mask_t = t < frames
            g = keep(mask_t, g2, g)
            state = [(keep(mask_t, h2, h), keep(mask_t, c2, c))
                     for (h2, c2), (h, c) in zip(state2, state)]
            out = keep(mask_t, out2, out)
            n_out = torch.where(mask_t, n_out2, n_out)
        return out

    def forward(self, batch: dict, key: torch.Tensor | None = None):
        """The loss. batch: features (B,T,F), labels (B,U), frame_len
        (B,), label_len (B,), optional weight (B,). ``key`` (a threefry
        key, ``core/keys.py``) draws the SpecAugment masks. Returns (mean
        loss, aux)."""
        cfg = self.cfg
        feats = batch["features"]
        if key is not None and cfg.specaug.enabled:
            feats = spec_augment(key, feats, cfg.specaug)
        enc = self.encode(feats)
        pred = self.predict(batch["labels"])
        joint = self.joint_fused if cfg.use_kernel else self.joint_logprobs
        blank_lp, label_lp = joint(enc, pred, batch["labels"])
        frame_len = torch.clamp(batch["frame_len"] // cfg.time_stride, min=1)
        nll = rnnt_loss_from_logprobs(blank_lp, label_lp, frame_len, batch["label_len"])
        if cfg.loss_norm:
            nll = nll / torch.clamp(batch["label_len"].float(), min=1.0)
        w = batch.get("weight")
        w = torch.ones_like(nll) if w is None else w
        loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
        return loss, {"nll": nll}


def init_params(cfg: RNNTConfig, generator: torch.Generator) -> dict:
    """Random parameters on ``generator``'s device, in the order and
    with the initializers of ``repro/models/rnnt.py:52-64``: dense
    weights N(0, 1/d_in), the embedding N(0, 1/d), biases zero."""
    params = {}
    for name, p in RNNT(cfg).named_parameters():
        if name == "pred_embed":
            params[name] = embed_init(generator, *p.shape, dtype=p.dtype)
        elif p.dim() == 2:
            params[name] = dense_init(generator, *p.shape, dtype=p.dtype)
        else:
            params[name] = torch.zeros(p.shape, dtype=p.dtype, device=generator.device)
    return params


def param_count(cfg: RNNTConfig) -> int:
    return sum(p.numel() for p in RNNT(cfg).parameters())


def greedy_decode(cfg: RNNTConfig, params: dict, features, frame_len, max_symbols: int = 4):
    """``RNNT.greedy_decode`` over an explicit parameter dict (the
    module's parameters become these tensors; nothing is copied)."""
    model = RNNT(cfg)
    model.load_state_dict(params, assign=True)
    with torch.no_grad():
        return model.greedy_decode(features, frame_len, max_symbols)


def loss_fn(model: RNNT, params: dict, batch: dict, key=None):
    """The functional loss over an explicit parameter dict; ``key`` is
    the client step's data key (``repro/models/rnnt.py:135``'s ``rng``)."""
    return functional_call(model, params, (batch,), {"key": key})
