"""Federated training driver of the port (the paper's experiment loop).

Runs FedAvg rounds of a registered task (``core/task.py``: the RNN-T,
the paper's model, the Whisper-style enc-dec, the decoder-only and MoE
language models, qwen3-8b at full width, or the keyword classifier) on
the synthetic speaker-split corpus with the paper's knobs (data limit,
FVN, server LR schedule) and CFMQ accounting, on the CUDA card unless the
caller asks for the CPU, and ends, as ``repro/launch/train.py`` does, with
the task's evaluation on the clean and hard eval splits: greedy decoding
and WER for the RNN-T, perplexity for the enc-dec and the language
models, the classification error for the keyword task.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --task asr-rnnt --rounds 4
    PYTHONPATH=src python -m repro_torch.launch.train --task asr-encdec --rounds 4
    PYTHONPATH=src python -m repro_torch.launch.train --task whisper-base --rounds 2 \\
        --clients 4 --batch 4 --data-limit 8 --fvn-std 0.01 --eval-every 0
    PYTHONPATH=src python -m repro_torch.launch.train --task lm-moe --rounds 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --task keyword --rounds 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --task qwen3-8b --rounds 2 \\
        --clients 4 --batch 4 --data-limit 8 --fvn-std 0.01 --server-lr 1e-5 --eval-every 0
    PYTHONPATH=src python -m repro_torch.launch.train --preset arch --rounds 2 \\
        --clients 4 --batch 4 --data-limit 8 --fvn-std 0.01
    PYTHONPATH=src python -m repro_torch.launch.train --preset arch --arch gemma3-4b \\
        --rounds 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 \\
        --compression int4 --packed-wire --error-feedback
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 \\
        --aggregator trimmed_mean --corrupt-kind sign_flip --corrupt-rate 0.25 \\
        --participation 0.75 --compression int4 --packed-wire
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 --iid --fvn-std 0.01
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 --engine fedsgd
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 \\
        --corrupt-kind label_shuffle --corrupt-rate 0.5
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 4 \\
        --engine async --buffer-size 3 --staleness-beta 0.5 --client-eval 6

The history is a summary row of ``core/metrics.py``'s schema (the task's
metric, WER, perplexity or error rate, as ``quality``/``quality_hard`` and named in
``quality_metric``), with the per-round curves as extras. A
task whose config has ``use_kernel=True`` runs its joint through the
fused joint kernels. With ``--compression {int8,int4,topk}`` the uplink
is compressed (aggregated in the code domain under the weighted mean),
and CFMQ prices the measured wire bytes. The plan's flags come from
``launch/cli.py`` (the reference's): the engine (``--engine``, and the
async engine's ``--buffer-size`` and ``--staleness-beta``), the latency
model, the aggregator, the compression, the cohort and the adversary.
``--iid`` trains on IID rounds packed from the shuffled global pool (the
paper's E0 baseline), ``--engine fedsgd`` collapses each round's clients
into one forward and backward, ``--engine async`` streams the clients'
uploads into a buffered server (``core/async_engine.py``), and
``--corrupt-kind label_shuffle`` poisons the sampled clients' transcripts
in the data plane. ``--client-eval N`` measures a panel of N clients every
round (``core/clienteval.py``): their spread fills the summary row, their
curves go into ``extras["client_eval"]``. ``run_federated``'s
``specaug_scale`` scales SpecAugment's mask counts (E10), and its
``ckpt_dir`` keeps checkpoints of the parameters (``checkpoint/``).

``--preset arch --arch <id>`` trains ``arch_task(<id>)``, the registry's
smoke config of that architecture on the shared corpus, as the reference
does. One departure: ``--arch rnnt-librispeech``, the default, trains the
paper's model at its full width on a corpus at its widths (the registered
``rnnt-librispeech`` task), where the reference takes its smoke config.
The VLM has no task (``arch_task`` raises, as the reference's): it trains
through ``core.fedavg.make_round_step`` on its own batches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import rnnt_librispeech
from repro_torch.core.cfmq import (accumulate_wire_bytes, cfmq, measured_payload,
                                   plan_wire_accounting)
from repro_torch.core.clienteval import ClientEvalPlane
from repro_torch.core.engine import build_round_engine
from repro_torch.core.metrics import empty_spread, summary_row
from repro_torch.core.plan import FederatedPlan, FVNConfig
from repro_torch.core.task import (FederatedTask, arch_task, available_tasks, default_corpus,
                                   get_task, scaled_task)
from repro_torch.data import FederatedSampler, available_strategies, pack_round
from repro_torch.launch.cli import add_client_eval_args, add_plan_args, plan_kwargs


def tiny_asr_setup(seed: int = 0):
    """The container-scale RNN-T config and corpus: the ``asr-rnnt``
    task's pieces as a tuple, for callers that predate FederatedTask."""
    return get_task("asr-rnnt").config, default_corpus(seed)


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


def next_round_batch(corpus, plan: FederatedPlan, sampler: FederatedSampler, iid: bool,
                     rng: np.random.Generator, native_steps: int):
    """A round's batch: from the sampler, or under ``iid`` packed at the
    plan's native step count from a fresh permutation of the global pool
    (the E0 baseline), then padded with weight-0 steps to the sampler's
    step count (a no-op unless the caller forced one)."""
    if not iid:
        return sampler.next_round()
    pool = corpus.iid_pool()
    idx = rng.permutation(pool["labels"].shape[0])
    return pack_round({k: v[idx] for k, v in pool.items()}, plan.clients_per_round,
                      native_steps, plan.local_batch_size).pad_steps(sampler.steps)


class RoundTally:
    """The per-round metrics a summary row reads, as host floats."""

    KEYS = ("loss", "examples", "participants", "corrupted", "sim_time_s", "server_steps",
            "staleness_mean")

    def __init__(self):
        self.curves = {k: [] for k in self.KEYS}

    def add(self, metrics: dict) -> None:
        for k in self.KEYS:
            self.curves[k].append(float(metrics[k]))


def summary_fields(task: FederatedTask, plan: FederatedPlan, params: dict, rounds: int,
                   native_steps: int, tally: RoundTally, corrupted, quality: dict,
                   spread: dict, wall_s: float) -> dict:
    """A run's summary-row fields (``core/metrics.py:SUMMARY_KEYS``): CFMQ
    over the native step count, the exact wire bytes from the rounds'
    participants, the rounds' tallies. ``corrupted`` is the rounds'
    corrupted clients (the engine's, or the sampler's for label_shuffle)."""
    c = tally.curves
    n_params = sum(p.numel() for p in params.values())
    up_per_client, down_per_round = plan_wire_accounting(plan, params)
    wire_total = accumulate_wire_bytes(up_per_client, down_per_round, c["participants"])
    mu = plan.local_epochs * (plan.data_limit or native_steps * plan.local_batch_size)
    terms = cfmq(rounds=rounds, clients_per_round=plan.clients_per_round,
                 model_bytes=n_params * plan.param_bytes,
                 local_steps=mu / plan.local_batch_size, alpha=plan.alpha,
                 payload_bytes=measured_payload(plan, params, float(np.mean(c["participants"]))))
    steps = c["server_steps"]
    steps_total = sum(steps)
    return dict(
        rounds=rounds,
        final_loss=float(np.mean(c["loss"][-5:])),
        quality=quality["quality"], quality_hard=quality["quality_hard"],
        quality_metric=task.quality_metric,
        **spread,
        cfmq_tb=terms.total_terabytes, cfmq_bytes=terms.total_bytes,
        payload_bytes=terms.payload_bytes,
        uplink_bytes_client=up_per_client,
        uplink_bytes_total=wire_total - down_per_round * rounds,
        wire_bytes_total=wire_total,
        downlink_bytes_round=down_per_round,
        participants_mean=float(np.mean(c["participants"])),
        corrupted_mean=float(np.mean(corrupted)) if corrupted else 0.0,
        corrupted_total=int(round(sum(corrupted))),
        n_params=n_params,
        sim_time_s=sum(c["sim_time_s"]),
        server_steps_total=steps_total,
        # a round's staleness_mean is over its applied deltas: weighted by
        # its server steps (a sync round: 1 step at staleness 0)
        staleness_mean=(sum(s * w for s, w in zip(c["staleness_mean"], steps)) / steps_total
                        if steps_total else 0.0),
        wall_s=wall_s,
    )


@dataclasses.dataclass
class FederatedRun:
    """What a run's round loop leaves for its summary row: the final
    state, the initial parameters (the wire accounting's shapes), the
    plan's native and the run's local-step counts, the rounds' tallies
    and times, the corrupted clients, the final quality, the per-client
    plane, and the training and final-evaluation seconds."""
    state: object
    params: dict
    native_steps: int
    local_steps: int
    tally: RoundTally
    round_s: list
    corrupted: list
    quality: dict
    plane: Optional[ClientEvalPlane]
    train_s: float
    eval_s: float

    def spread(self) -> dict:
        return self.plane.spread() if self.plane is not None else empty_spread()


def federated_rounds(task: FederatedTask, corpus, plan: FederatedPlan, rounds: int,
                     seed: int = 0, device: str | None = None, iid: bool = False,
                     eval_every: int = 0, eval_examples: int = 64, log=print,
                     ckpt_dir: str | None = None, client_eval: int = 0,
                     client_eval_examples: int = 4, steps: int | None = None) -> FederatedRun:
    """The round loop that ``run_federated`` and the sweep runner share
    (arguments as ``run_federated``'s). ``steps`` forces the local-step
    count, padding with weight-0 steps; CFMQ counts the native one."""
    _check_iid_corruption(plan, iid)
    device = resolve_device(device)
    params = task.init_params(torch.Generator(device=device).manual_seed(seed))
    engine = build_round_engine(plan, task, seed=seed + 1)
    state = engine.init_state(params)
    native = FederatedSampler.natural_steps(
        corpus, plan.local_batch_size, data_limit=plan.data_limit,
        local_epochs=plan.local_epochs, max_steps=plan.local_steps)
    sampler = FederatedSampler(
        corpus, clients_per_round=plan.clients_per_round,
        local_batch_size=plan.local_batch_size, data_limit=plan.data_limit,
        local_epochs=plan.local_epochs, seed=seed, steps=steps if steps is not None else native,
        strategy=plan.client_sampling,
        label_shuffle_rate=(plan.corruption.rate if plan.corruption.kind == "label_shuffle"
                            else 0.0))
    rng = np.random.default_rng(seed)  # the IID rounds' permutations
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    plane = (ClientEvalPlane(task, corpus, clients=client_eval, n=client_eval_examples)
             if client_eval > 0 else None)

    t0 = time.perf_counter()
    tally, round_s = RoundTally(), []
    for r in range(rounds):
        rb = next_round_batch(corpus, plan, sampler, iid, rng, native)
        batch = _to_device(rb.engine_batch(), device)
        t_round = time.perf_counter()
        state, metrics = engine.step(state, batch)  # metrics are host floats: synced
        round_s.append(time.perf_counter() - t_round)
        tally.add(metrics)
        loss = metrics["loss"]
        log(f"round {r + 1}: loss={loss:.4f} ({round_s[-1]:.3f} s)")
        if plane is not None:
            plane.measure(state.params)
        if eval_every and (r + 1) % eval_every == 0:
            q = task.evaluate(state.params, corpus, eval_examples)
            log(f"round {r + 1}: loss={loss:.4f} "
                f"{task.quality_metric}={q['quality']:.3f} "
                f"{task.quality_metric}_hard={q['quality_hard']:.3f}")
        if ckpt and (r + 1) % max(1, rounds // 3) == 0:
            ckpt.save(r + 1, state.params, extra={
                "wire_bytes": accumulate_wire_bytes(*plan_wire_accounting(plan, params),
                                                    tally.curves["participants"]),
                "participants_mean": float(np.mean(tally.curves["participants"]))})
    train_s = time.perf_counter() - t0

    t_eval = time.perf_counter()
    quality = (task.evaluate(state.params, corpus, eval_examples) if eval_examples
               else {"quality": float("nan"), "quality_hard": float("nan")})
    eval_s = time.perf_counter() - t_eval
    # the data-plane adversary's counts live on the sampler
    corrupted = ([float(c) for c in sampler.corrupted_counts]
                 if plan.corruption.kind == "label_shuffle" else tally.curves["corrupted"])
    return FederatedRun(state, params, native, sampler.steps, tally, round_s, corrupted,
                        quality, plane, train_s, eval_s)


def run_federated(task: FederatedTask, corpus, plan: FederatedPlan, rounds: int,
                  seed: int = 0, device: str | None = None, iid: bool = False,
                  eval_every: int = 0, eval_examples: int = 64,
                  specaug_scale: float = 1.0, log=print, ckpt_dir: str | None = None,
                  client_eval: int = 0, client_eval_examples: int = 4):
    """Returns (state, history): a summary row (final loss, the task's
    quality, CFMQ, the exact wire bytes) with the per-round losses and
    times as extras. Every ``eval_every`` rounds, and at the end, the model
    is evaluated on ``eval_examples`` examples of each eval split; with
    ``eval_examples=0`` there is no final evaluation and the quality is NaN.
    ``iid`` packs every round from a fresh permutation of the global pool
    (the E0 baseline); ``specaug_scale`` scales SpecAugment's mask counts
    (E10). ``client_eval`` > 0 measures that many clients'
    (``client_eval_examples`` each) loss and quality after every round: the
    spread fills the row, the curves go into ``extras["client_eval"]``.
    With ``ckpt_dir`` the parameters are saved every ``rounds // 3``
    rounds (at least every round), the last three kept."""
    if specaug_scale != 1.0:
        task = scaled_task(task, specaug_scale)
    run = federated_rounds(task, corpus, plan, rounds, seed=seed, device=device, iid=iid,
                           eval_every=eval_every, eval_examples=eval_examples, log=log,
                           ckpt_dir=ckpt_dir, client_eval=client_eval,
                           client_eval_examples=client_eval_examples)
    extras = {
        "task": task.name,
        "device": str(resolve_device(device)),
        "loss": run.tally.curves["loss"],
        "round_s": run.round_s,
        "examples": run.tally.curves["examples"],
        "local_steps": run.local_steps,
        "eval_s": run.eval_s,
    }
    if run.plane is not None:
        extras["client_eval"] = run.plane.curves()
    history = summary_row(
        **summary_fields(task, plan, run.params, rounds, run.native_steps, run.tally,
                         run.corrupted, run.quality, run.spread(), run.train_s),
        extras=extras)
    return run.state, history


def run_federated_asr(cfg, corpus, plan: FederatedPlan, rounds: int, **kwargs):
    """The config-first entry point that predates FederatedTask: the task
    around ``cfg``, then ``run_federated``."""
    return run_federated(FederatedTask(cfg.name, cfg, default_corpus), corpus, plan, rounds,
                         **kwargs)


def build_plan(args) -> FederatedPlan:
    return FederatedPlan(
        clients_per_round=args.clients, local_batch_size=args.batch,
        data_limit=args.data_limit, client_lr=args.client_lr,
        client_sampling=args.client_sampling,
        server_lr=args.server_lr, server_warmup_rounds=max(2, args.rounds // 8),
        fvn=FVNConfig(enabled=args.fvn_std > 0, std=args.fvn_std, ramp_rounds=args.fvn_ramp),
        **plan_kwargs(args),
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default=None, choices=available_tasks(),
                    help="a registered task; overrides --preset and --arch")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "arch"],
                    help="tiny: asr-rnnt; arch: the --arch architecture")
    ap.add_argument("--arch", default=rnnt_librispeech.ARCH_ID,
                    help="with --preset arch: an id of configs/registry.py, its smoke config "
                         "(rnnt-librispeech, the default: the paper's model at full width)")
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
    add_plan_args(ap)
    add_client_eval_args(ap)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--eval-every", type=int, default=10,
                    help="evaluate and print the task's metric every this many rounds "
                         "(0: only at the end)")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def resolve_task(args) -> FederatedTask:
    """--task, else --preset tiny's asr-rnnt, else --arch's task: the
    paper-width rnnt-librispeech task for that id, arch_task otherwise."""
    if args.task is not None:
        return get_task(args.task, args.seed)
    if args.preset == "tiny":
        return get_task("asr-rnnt", args.seed)
    if args.arch == rnnt_librispeech.ARCH_ID:
        return get_task(rnnt_librispeech.ARCH_ID, args.seed)
    return arch_task(args.arch)


def main(argv=None):
    args = parse_args(argv)

    task = resolve_task(args)
    _, hist = run_federated(task, task.make_corpus(args.seed), build_plan(args), args.rounds,
                            seed=args.seed, device=args.device, iid=args.iid,
                            eval_every=args.eval_every, client_eval=args.client_eval,
                            client_eval_examples=args.client_eval_examples)
    curves = ("loss", "round_s", "examples", "client_eval")
    print(json.dumps({k: v for k, v in hist.items() if k not in curves}, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist, f)
    return hist


if __name__ == "__main__":
    main()
