"""Federated training driver of the port (the paper's experiment loop).

Runs FedAvg rounds of the RNN-T on the synthetic speaker-split corpus
with the paper's knobs (data limit, FVN, server LR schedule) and CFMQ
accounting, on the CUDA card unless the caller asks for the CPU.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --task asr-rnnt --rounds 4
    PYTHONPATH=src python -m repro_torch.launch.train --preset arch --rounds 2 \\
        --clients 4 --batch 4 --data-limit 8 --fvn-std 0.01

Evaluation (greedy decoding and WER) is not ported yet: the summary
reports the loss, CFMQ and the wire bytes.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import rnnt_librispeech
from repro_torch.core.cfmq import cfmq, plan_wire_accounting, round_wire_bytes
from repro_torch.core.engine import build_round_engine
from repro_torch.core.plan import FederatedPlan, FVNConfig
from repro_torch.core.task import FederatedTask, get_task
from repro_torch.data import FederatedSampler, available_strategies


def resolve_device(device: str | None) -> torch.device:
    """The device a run uses: CUDA unless ``device`` names another. A
    run never moves to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


def _to_device(batch: dict, device: torch.device) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def run_federated(task: FederatedTask, corpus, plan: FederatedPlan, rounds: int,
                  seed: int = 0, device: str | None = None, eval_every: int = 0,
                  log=print):
    """Returns (state, history): the per-round losses and times, CFMQ and
    the exact wire bytes."""
    if eval_every > 0:
        raise NotImplementedError(
            "evaluation (greedy_decode + asr/wer.py) is not ported yet; run with eval_every=0")
    device = resolve_device(device)
    params = task.init_params(torch.Generator(device=device).manual_seed(seed))
    n_params = sum(p.numel() for p in params.values())
    engine = build_round_engine(plan, task, seed=seed + 1)
    state = engine.init_state(params)
    sampler = FederatedSampler(
        corpus, clients_per_round=plan.clients_per_round,
        local_batch_size=plan.local_batch_size, data_limit=plan.data_limit,
        local_epochs=plan.local_epochs, seed=seed, max_steps=plan.local_steps,
        strategy=plan.client_sampling)
    up_per_client, down_per_round = plan_wire_accounting(plan, params)

    t0 = time.perf_counter()
    wire_total = 0
    losses, examples, round_s = [], [], []
    for r in range(rounds):
        batch = _to_device(sampler.next_round().engine_batch(), device)
        t_round = time.perf_counter()
        state, metrics = engine.step(state, batch)  # metrics are host floats: synced
        round_s.append(time.perf_counter() - t_round)
        losses.append(metrics["loss"])
        examples.append(metrics["examples"])
        wire_total += round_wire_bytes(up_per_client, down_per_round, metrics["participants"])
        log(f"round {r + 1}: loss={losses[-1]:.4f} ({round_s[-1]:.3f} s)")
    train_time_s = time.perf_counter() - t0

    mu = plan.local_epochs * (plan.data_limit or sampler.steps * plan.local_batch_size)
    terms = cfmq(rounds=rounds, clients_per_round=plan.clients_per_round,
                 model_bytes=n_params * plan.param_bytes,
                 local_steps=mu / plan.local_batch_size, alpha=plan.alpha)
    history = {
        "task": task.name,
        "device": str(device),
        "rounds": rounds,
        "final_loss": float(np.mean(losses[-5:])),
        "loss": losses,
        "round_s": round_s,
        "examples": examples,
        "cfmq_tb": terms.total_terabytes,
        "cfmq_bytes": terms.total_bytes,
        "payload_bytes": terms.payload_bytes,
        "uplink_bytes_client": up_per_client,
        "uplink_bytes_total": wire_total - down_per_round * rounds,
        "wire_bytes_total": wire_total,
        "downlink_bytes_round": down_per_round,
        "n_params": n_params,
        "local_steps": sampler.steps,
        "wall_s": train_time_s,
    }
    return state, history


def build_plan(args) -> FederatedPlan:
    return FederatedPlan(
        clients_per_round=args.clients, local_batch_size=args.batch,
        data_limit=args.data_limit, client_lr=args.client_lr,
        client_sampling=args.client_sampling,
        server_lr=args.server_lr, server_warmup_rounds=max(2, args.rounds // 8),
        fvn=FVNConfig(enabled=args.fvn_std > 0, std=args.fvn_std, ramp_rounds=args.fvn_ramp),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default=None, choices=["asr-rnnt"],
                    help="a registered task; overrides --preset")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "arch"],
                    help="tiny: asr-rnnt; arch: rnnt-librispeech at paper widths")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--data-limit", type=int, default=None)
    ap.add_argument("--fvn-std", type=float, default=0.0)
    ap.add_argument("--fvn-ramp", type=int, default=0)
    ap.add_argument("--server-lr", type=float, default=0.01)
    ap.add_argument("--client-lr", type=float, default=0.05)
    ap.add_argument("--client-sampling", default="uniform", choices=available_strategies())
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="must stay 0: evaluation is not ported yet")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    name = args.task or ("asr-rnnt" if args.preset == "tiny" else rnnt_librispeech.ARCH_ID)
    task = get_task(name)
    _, hist = run_federated(task, task.make_corpus(args.seed), build_plan(args), args.rounds,
                            seed=args.seed, device=args.device, eval_every=args.eval_every)
    curves = ("loss", "round_s", "examples")
    print(json.dumps({k: v for k, v in hist.items() if k not in curves}, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist, f)
    return hist


if __name__ == "__main__":
    main()
