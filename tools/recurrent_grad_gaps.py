#!/usr/bin/env python3
"""How well conditioned rwkv6-1.6b's loss and gradient are at init, by depth.

On one CUDA card, from the rwkv6-1.6b task's random parameters (seed 0) and
one client batch of its first round (4 label rows of 128 tokens), for each
depth in --layers (the first n layers of the 24) and each compute dtype:

- the loss and every leaf's gradient with K12 (the WKV-6 kernels) and with
  K12's plain versions on the card (``chip_smoke._plain_recurrences_on_card``):
  the loss gap and the worst leaf's gradient gap relative to its largest
  entry, and the embedding's largest gradient entry;
- in bf16, the same against the fp32 model on the kernels;
- at full depth in bf16, the loss after one local SGD step at each
  --client-lr, on the kernels and on the plain versions;
- for each depth in --serve-layers, in bf16 (and in fp32 at 4 and 24
  layers): a serve of B=4 prompts of 128 tokens (eval-split label rows,
  ``prefill``) and 32 greedy ``decode_step``s, its logits against a
  teacher-forced forward over prompt and generated tokens, and the floor:
  that forward on K12's plain versions against it (relative to the largest
  logit, as ``chip_smoke.py``'s serves);
- for each seed below --round-seeds and each --round-lr: one FedAvg round
  (K=4, b=4, 2 local steps, FVN 0.01, server SGD at 1) of rwkv6-1.6b's
  width at 4 layers in fp32, on the kernels and on the plain versions: the
  round's loss gap and the aggregated delta's largest gap relative to its
  largest entry.

It prints one line a comparison and the card's name and power limit. Run from
the repository's root:

    python3 tools/recurrent_grad_gaps.py [--layers 1 4 24] [--client-lr 0.05 1e-4]
        [--serve-layers 1 4 8 24] [--round-seeds 5] [--round-lr 0.05 1e-3]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 4, 24])
    ap.add_argument("--client-lr", type=float, nargs="+", default=[0.05, 1e-4])
    ap.add_argument("--serve-layers", type=int, nargs="*", default=[1, 4, 8, 24])
    ap.add_argument("--round-seeds", type=int, default=5)
    ap.add_argument("--round-lr", type=float, nargs="*", default=[0.05, 1e-3])
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.core.task import get_task
    from repro_torch.data import FederatedSampler
    from repro_torch.models import model_zoo

    cs.phase_card(torch)
    task = get_task("rwkv6-1.6b")
    params = task.init_params(torch.Generator(device="cuda").manual_seed(0))
    corpus = task.make_corpus(0)
    rb = FederatedSampler(corpus, 4, 4, data_limit=8, seed=0).next_round()
    eb = rb.engine_batch()
    batch = {"tokens": torch.from_numpy(eb["labels"][0, 0]).cuda(),
             "weight": torch.from_numpy(eb["weight"][0, 0]).cuda()}

    def run(dtype: str, plain: bool, layers: int, lr=None):
        cfg = dataclasses.replace(task.config, dtype=dtype, param_dtype=dtype, n_layers=layers)
        bundle = model_zoo.build_model(cfg)
        p = {k: (v[:layers] if k.startswith("layers.") else v).to(getattr(torch, dtype))
             .detach().requires_grad_(True) for k, v in params.items()}
        with cs._plain_recurrences_on_card() if plain else contextlib.nullcontext():
            loss, _ = bundle.loss_fn(p, batch)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            after = None
            if lr is not None:
                with torch.no_grad():
                    after = float(bundle.loss_fn({k: v - lr * grads[k] for k, v in p.items()},
                                                 batch)[0])
        return float(loss.detach()), {k: g.float() for k, g in grads.items()}, after

    def gap(a, b) -> str:
        worst = max((float((a[1][n] - b[1][n]).abs().max())
                     / max(float(b[1][n].abs().max()), 1e-30), n) for n in a[1])
        return (f"loss {a[0]:.6f} vs {b[0]:.6f} (relative gap {abs(a[0] - b[0]) / b[0]:.3e}); "
                f"worst gradient gap {worst[0]:.3e} ({worst[1]}); largest embedding gradient "
                f"{float(b[1]['embed'].abs().max()):.4g}")

    for layers in args.layers:
        f32 = run("float32", False, layers)
        print(f"[gaps] {layers} layers, fp32, kernels vs plain: "
              f"{gap(f32, run('float32', True, layers))}", flush=True)
        b16 = run("bfloat16", False, layers)
        print(f"[gaps] {layers} layers, bf16, kernels vs plain: "
              f"{gap(b16, run('bfloat16', True, layers))}", flush=True)
        print(f"[gaps] {layers} layers, bf16 vs fp32, kernels: {gap(b16, f32)}", flush=True)
        del f32, b16
        torch.cuda.empty_cache()
    full = task.config.n_layers
    for lr in args.client_lr:
        k = run("bfloat16", False, full, lr)
        p = run("bfloat16", True, full, lr)
        print(f"[gaps] {full} layers, bf16, one SGD step at lr {lr}: loss {k[0]:.6f} -> "
              f"{k[2]:.6f} on the kernels, {p[0]:.6f} -> {p[2]:.6f} on the plain versions "
              f"(relative gap after it {abs(k[2] - p[2]) / p[2]:.3e})", flush=True)
        del k, p
        torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        for layers in args.serve_layers:
            if dtype == "bfloat16" or layers in (4, 24):
                print(serve_gaps(cs, task, params, corpus, dtype, layers), flush=True)
                torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    for lr in args.round_lr:
        for seed in range(args.round_seeds):
            print(round_gaps(cs, corpus, lr, seed), flush=True)
    return 0


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1.0)


def serve_gaps(cs, task, params, corpus, dtype: str, layers: int) -> str:
    """One line: the serve's logits against the teacher-forced forward, and
    that forward on K12's plain versions against it."""
    import torch

    from repro_torch.models import model_zoo

    cfg = dataclasses.replace(task.config, dtype=dtype, param_dtype=dtype, n_layers=layers)
    bundle = model_zoo.build_model(cfg)
    p = {k: (v[:layers] if k.startswith("layers.") else v).to(getattr(torch, dtype))
         for k, v in params.items()}
    prompt = torch.from_numpy(corpus.eval_split(4)["labels"][:, :128]).to("cuda", torch.long)
    with torch.no_grad():
        logits, state = bundle.prefill(p, {"tokens": prompt})
        steps, fed = [logits], []
        for i in range(32):
            fed.append(steps[-1].argmax(-1, keepdim=True))
            logits, state = bundle.decode_step(p, state, fed[-1], 128 + i)
            steps.append(logits)
        tokens = torch.cat([prompt, *fed], dim=1)

        def forward(plain: bool):
            with cs._plain_recurrences_on_card() if plain else contextlib.nullcontext():
                h, _ = model_zoo._rwkv_forward(cfg, p, tokens)
            return (h[:, 127:] @ p["unembed"].to(cfg.cdtype)).float().transpose(0, 1)

        tf = forward(False)
        dec = torch.stack(steps)
        floor = _rel(forward(True), tf)
        same = float((dec.argmax(-1) == tf.argmax(-1)).float().mean())
    return (f"[serve] {layers} layers, {dtype}: decode vs the teacher-forced forward "
            f"{_rel(dec, tf):.3e}; floor (that forward on the plain versions) {floor:.3e}; "
            f"argmax equal at {same:.4f}")


def round_gaps(cs, corpus, lr: float, seed: int) -> str:
    """One line: a 4-layer fp32 round on the kernels against the plain
    versions."""
    import torch

    from repro_torch.configs import rwkv6_1p6b
    from repro_torch.core.engine import build_round_engine
    from repro_torch.core.plan import FederatedPlan, FVNConfig
    from repro_torch.core.task import task_for_config
    from repro_torch.data import FederatedSampler

    task = task_for_config(rwkv6_1p6b.make_config(n_layers=4, dtype="float32",
                                                  param_dtype="float32"))
    plan = FederatedPlan(clients_per_round=4, local_batch_size=4, data_limit=8, client_lr=lr,
                         server_optimizer="sgd", server_lr=1.0,
                         fvn=FVNConfig(enabled=True, std=0.01))
    params = task.init_params(torch.Generator(device="cuda").manual_seed(seed))
    rb = FederatedSampler(corpus, 4, 4, data_limit=8, seed=seed).next_round()
    batch = {k: torch.from_numpy(v).cuda() for k, v in rb.engine_batch().items()}
    out = {}
    for plain in (False, True):
        engine = build_round_engine(plan, task, seed=seed + 1)
        with cs._plain_recurrences_on_card() if plain else contextlib.nullcontext():
            state, metrics = engine.step(engine.init_state(dict(params)), batch)
        out[plain] = (metrics["loss"], {k: params[k] - state.params[k] for k in params})
    (lk, dk), (lp, dp) = out[False], out[True]
    top = max(float(d.abs().max()) for d in dp.values())
    gap = max(float((dk[k] - dp[k]).abs().max()) for k in dp) / top
    return (f"[round] 4 layers, fp32, client lr {lr}, seed {seed}: loss {lk:.7f} vs {lp:.7f} "
            f"on the plain versions (relative gap {abs(lk - lp) / lp:.3e}); aggregated delta "
            f"gap {gap:.3e} of its largest entry {top:.3e}")


if __name__ == "__main__":
    sys.exit(main())
