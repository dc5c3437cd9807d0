"""Federated training driver of the port (the paper's experiment loop).

Runs FedAvg rounds of the RNN-T on the synthetic speaker-split corpus
with the paper's knobs (data limit, FVN, server LR schedule) and CFMQ
accounting, on the CUDA card unless the caller asks for the CPU, and
ends, as ``repro/launch/train.py`` does, with greedy decoding and WER on
the clean and hard eval splits.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --task asr-rnnt --rounds 4
    PYTHONPATH=src python -m repro_torch.launch.train --preset arch --rounds 2 \\
        --clients 4 --batch 4 --data-limit 8 --fvn-std 0.01
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 \\
        --compression int4 --packed-wire --error-feedback
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 \\
        --aggregator trimmed_mean --corrupt-kind sign_flip --corrupt-rate 0.25 \\
        --participation 0.75 --compression int4 --packed-wire
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 --iid --fvn-std 0.01
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 --engine fedsgd
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 \\
        --corrupt-kind label_shuffle --corrupt-rate 0.5

The history is a summary row of ``core/metrics.py``'s schema (WER as
``quality``/``quality_hard``), with the per-round curves as extras. A
task whose config has ``use_kernel=True`` runs its joint through the
fused joint kernels. With ``--compression {int8,int4,topk}`` the uplink
is compressed (aggregated in the code domain under the weighted mean),
and CFMQ prices the measured wire bytes. The server plane's flags are the
reference's (``repro/launch/cli.py:83-125``): the cohort
(``--participation``, ``--straggler-frac``, ``--straggler-keep``), the
aggregator (``--aggregator``, ``--trim-frac``, ``--dp-clip``,
``--dp-sigma``), the adversary (``--corrupt-kind``, ``--corrupt-rate``,
``--corrupt-scale``) and the latency model (``--latency``,
``--latency-base-s``, ``--latency-spread``). ``--iid`` trains on IID
rounds packed from the shuffled global pool (the paper's E0 baseline),
``--engine fedsgd`` collapses each round's clients into one forward and
backward, and ``--corrupt-kind label_shuffle`` poisons the sampled
clients' transcripts in the data plane. ``run_federated``'s
``specaug_scale`` scales SpecAugment's mask counts (E10).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import rnnt_librispeech
from repro_torch.core.cfmq import cfmq, measured_payload, plan_wire_accounting, round_wire_bytes
from repro_torch.core.aggregation import available_aggregators
from repro_torch.core.cohort import LatencyConfig
from repro_torch.core.compression import KINDS, CompressionConfig
from repro_torch.core.corruption import CorruptionConfig, available_corruptions
from repro_torch.core.engine import build_round_engine
from repro_torch.core.metrics import empty_spread, summary_row
from repro_torch.core.plan import AggregatorConfig, CohortConfig, FederatedPlan, FVNConfig
from repro_torch.core.task import FederatedTask, get_task, scaled_task
from repro_torch.data import FederatedSampler, available_strategies, pack_round


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


def _check_iid_corruption(plan: FederatedPlan, iid: bool) -> None:
    if iid and plan.corruption.kind == "label_shuffle":
        raise ValueError(
            "label_shuffle corrupts labels inside the FederatedSampler, but "
            "--iid packs rounds from the global pool and bypasses the "
            "sampler — the adversary would silently never fire. Use a "
            "non-IID run (or a delta corruption kind, which is engine-side "
            "and composes with --iid)")


def run_federated(task: FederatedTask, corpus, plan: FederatedPlan, rounds: int,
                  seed: int = 0, device: str | None = None, iid: bool = False,
                  eval_every: int = 0, eval_examples: int = 64,
                  specaug_scale: float = 1.0, log=print):
    """Returns (state, history): a summary row (final loss, WER, CFMQ,
    the exact wire bytes) with the per-round losses and times as
    extras. Every ``eval_every`` rounds, and at the end, the model is
    decoded on ``eval_examples`` examples of each eval split; with
    ``eval_examples=0`` there is no final decode and the WER is NaN.
    ``iid`` packs every round from a fresh permutation of the global pool
    (the E0 baseline); ``specaug_scale`` scales SpecAugment's mask counts
    (E10)."""
    _check_iid_corruption(plan, iid)
    if specaug_scale != 1.0:
        task = scaled_task(task, specaug_scale)
    device = resolve_device(device)
    params = task.init_params(torch.Generator(device=device).manual_seed(seed))
    n_params = sum(p.numel() for p in params.values())
    engine = build_round_engine(plan, task, seed=seed + 1)
    state = engine.init_state(params)
    sampler = FederatedSampler(
        corpus, clients_per_round=plan.clients_per_round,
        local_batch_size=plan.local_batch_size, data_limit=plan.data_limit,
        local_epochs=plan.local_epochs, seed=seed, max_steps=plan.local_steps,
        strategy=plan.client_sampling,
        label_shuffle_rate=(plan.corruption.rate if plan.corruption.kind == "label_shuffle"
                            else 0.0))
    rng = np.random.default_rng(seed)  # the IID rounds' permutations
    up_per_client, down_per_round = plan_wire_accounting(plan, params)

    t0 = time.perf_counter()
    wire_total = 0
    losses, examples, round_s = [], [], []
    participants, corrupted, sim_times, server_steps, staleness = [], [], [], [], []
    for r in range(rounds):
        if iid:
            # a fresh IID shuffle of the global pool each round
            pool = corpus.iid_pool()
            idx = rng.permutation(pool["labels"].shape[0])
            rb = pack_round({k: v[idx] for k, v in pool.items()}, plan.clients_per_round,
                            sampler.steps, plan.local_batch_size)
        else:
            rb = sampler.next_round()
        batch = _to_device(rb.engine_batch(), device)
        t_round = time.perf_counter()
        state, metrics = engine.step(state, batch)  # metrics are host floats: synced
        round_s.append(time.perf_counter() - t_round)
        losses.append(metrics["loss"])
        examples.append(metrics["examples"])
        participants.append(float(metrics["participants"]))
        corrupted.append(metrics["corrupted"])
        sim_times.append(metrics["sim_time_s"])
        server_steps.append(metrics["server_steps"])
        staleness.append(metrics["staleness_mean"])
        wire_total += round_wire_bytes(up_per_client, down_per_round, metrics["participants"])
        log(f"round {r + 1}: loss={losses[-1]:.4f} ({round_s[-1]:.3f} s)")
        if eval_every and (r + 1) % eval_every == 0:
            q = task.evaluate(state.params, corpus, eval_examples)
            log(f"round {r + 1}: loss={losses[-1]:.4f} "
                f"{task.quality_metric}={q['quality']:.3f} "
                f"{task.quality_metric}_hard={q['quality_hard']:.3f}")
    train_time_s = time.perf_counter() - t0

    t_eval = time.perf_counter()
    quality = (task.evaluate(state.params, corpus, eval_examples) if eval_examples
               else {"quality": float("nan"), "quality_hard": float("nan")})
    eval_s = time.perf_counter() - t_eval
    mu = plan.local_epochs * (plan.data_limit or sampler.steps * plan.local_batch_size)
    terms = cfmq(rounds=rounds, clients_per_round=plan.clients_per_round,
                 model_bytes=n_params * plan.param_bytes,
                 local_steps=mu / plan.local_batch_size, alpha=plan.alpha,
                 payload_bytes=measured_payload(plan, params, float(np.mean(participants))))
    if plan.corruption.kind == "label_shuffle":
        # the data-plane adversary: its counts live on the sampler
        corrupted = [float(c) for c in sampler.corrupted_counts]
    steps_total = sum(server_steps)
    history = summary_row(
        rounds=rounds,
        final_loss=float(np.mean(losses[-5:])),
        quality=quality["quality"], quality_hard=quality["quality_hard"],
        quality_metric=task.quality_metric,
        **empty_spread(),
        cfmq_tb=terms.total_terabytes, cfmq_bytes=terms.total_bytes,
        payload_bytes=terms.payload_bytes,
        uplink_bytes_client=up_per_client,
        uplink_bytes_total=wire_total - down_per_round * rounds,
        wire_bytes_total=wire_total,
        downlink_bytes_round=down_per_round,
        participants_mean=float(np.mean(participants)),
        corrupted_mean=float(np.mean(corrupted)),
        corrupted_total=int(round(sum(corrupted))),
        n_params=n_params,
        sim_time_s=sum(sim_times),
        server_steps_total=steps_total,
        staleness_mean=(sum(s * w for s, w in zip(staleness, server_steps)) / steps_total
                        if steps_total else 0.0),
        wall_s=train_time_s,
        extras={
            "task": task.name,
            "device": str(device),
            "loss": losses,
            "round_s": round_s,
            "examples": examples,
            "local_steps": sampler.steps,
            "eval_s": eval_s,
        },
    )
    return state, history


def build_plan(args) -> FederatedPlan:
    return FederatedPlan(
        clients_per_round=args.clients, local_batch_size=args.batch,
        data_limit=args.data_limit, client_lr=args.client_lr,
        client_sampling=args.client_sampling,
        server_lr=args.server_lr, server_warmup_rounds=max(2, args.rounds // 8),
        fvn=FVNConfig(enabled=args.fvn_std > 0, std=args.fvn_std, ramp_rounds=args.fvn_ramp),
        compression=CompressionConfig(kind=args.compression, topk_frac=args.topk_frac,
                                      packed=args.packed_wire,
                                      error_feedback=args.error_feedback),
        cohort=CohortConfig(participation=args.participation,
                            straggler_frac=args.straggler_frac,
                            straggler_keep=args.straggler_keep),
        aggregation=AggregatorConfig(name=args.aggregator, trim_frac=args.trim_frac,
                                     dp_clip=args.dp_clip, dp_sigma=args.dp_sigma),
        corruption=CorruptionConfig(kind=args.corrupt_kind, rate=args.corrupt_rate,
                                    scale=args.corrupt_scale),
        latency=LatencyConfig(enabled=args.latency, base_s=args.latency_base_s,
                              spread=args.latency_spread),
        engine=args.engine,
    )


def parse_args(argv=None) -> argparse.Namespace:
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
    ap.add_argument("--iid", action="store_true",
                    help="pack each round from a fresh shuffle of the global pool (E0)")
    ap.add_argument("--client-sampling", default="uniform", choices=available_strategies())
    ap.add_argument("--engine", default="fedavg", choices=["fedavg", "fedsgd", "async"],
                    help="barrier FedAvg or FedSGD (async is not ported: the plan refuses it)")
    comp = ap.add_argument_group("compression")
    comp.add_argument("--compression", default="none", choices=list(KINDS),
                      help="uplink delta compression (exact wire bytes in CFMQ)")
    comp.add_argument("--topk-frac", type=float, default=0.05)
    comp.add_argument("--packed-wire", action="store_true",
                      help="materialize and unpack the wire payload (same numbers)")
    comp.add_argument("--error-feedback", action="store_true",
                      help="EF21 per-client residual accumulation (same wire bytes)")
    coh = ap.add_argument_group("cohort dynamics")
    coh.add_argument("--participation", type=float, default=1.0,
                     help="P(sampled client reports back)")
    coh.add_argument("--straggler-frac", type=float, default=0.0)
    coh.add_argument("--straggler-keep", type=float, default=0.5,
                     help="fraction of local steps a straggler completes")
    agg = ap.add_argument_group("aggregation")
    agg.add_argument("--aggregator", default="weighted_mean", choices=available_aggregators())
    agg.add_argument("--trim-frac", type=float, default=0.1,
                     help="trimmed_mean: fraction trimmed per side")
    agg.add_argument("--dp-clip", type=float, default=1.0,
                     help="clipped_mean: per-client L2 clip norm")
    agg.add_argument("--dp-sigma", type=float, default=0.0,
                     help="clipped_mean: DP Gaussian noise multiplier")
    cor = ap.add_argument_group("corruption")
    cor.add_argument("--corrupt-kind", default="none",
                     choices=["none", "label_shuffle"] + available_corruptions(),
                     help="adversary: a delta corruption, or label_shuffle (the data "
                          "plane's transcript shuffle)")
    cor.add_argument("--corrupt-rate", type=float, default=0.0,
                     help="P(participating client is corrupted) per round")
    cor.add_argument("--corrupt-scale", type=float, default=1.0,
                     help="adversary magnitude (sign_flip/gaussian/stale)")
    lat = ap.add_argument_group("latency")
    lat.add_argument("--latency", action="store_true",
                     help="price rounds in simulated seconds too (sim_time_s)")
    lat.add_argument("--latency-base-s", type=float, default=60.0,
                     help="device-tier latency model: base upload seconds")
    lat.add_argument("--latency-spread", type=float, default=0.25,
                     help="device-tier latency model: lognormal jitter std")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--eval-every", type=int, default=10,
                    help="decode and print the WER every this many rounds (0: only at "
                         "the end)")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    name = args.task or ("asr-rnnt" if args.preset == "tiny" else rnnt_librispeech.ARCH_ID)
    task = get_task(name)
    _, hist = run_federated(task, task.make_corpus(args.seed), build_plan(args), args.rounds,
                            seed=args.seed, device=args.device, iid=args.iid,
                            eval_every=args.eval_every)
    curves = ("loss", "round_s", "examples")
    print(json.dumps({k: v for k, v in hist.items() if k not in curves}, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist, f)
    return hist


if __name__ == "__main__":
    main()
