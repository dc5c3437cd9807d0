"""Shared argparse builders for the federated plan's knobs.

The port of ``repro/launch/cli.py``: ``launch/train.py`` and
``launch/sweeps.py`` take their plan flags from here, so the two CLIs
cannot drift.

- ``add_plan_args(parser)``: every FederatedPlan-shaping knob (engine,
  the async buffer and latency, aggregation, compression, cohort
  dynamics, corruption) as argument groups;
- ``add_client_eval_args(parser)``: the per-client evaluation plane's
  panel size and examples a client;
- ``plan_kwargs(args)``: the parsed flags as FederatedPlan keyword
  arguments, for drivers to splice with their own budget and schedule;
- ``plan_overrides(args)``: the part of ``plan_kwargs`` the command line
  moved off its defaults (a sweep's grid-wide overrides).

The reference's population-scale flags (``SCALE_FLAGS``:
``--population``, ``--mesh-clients``) wait for ROADMAP M9.
"""

from __future__ import annotations

import argparse

from repro_torch.core.aggregation import available_aggregators
from repro_torch.core.cohort import LatencyConfig
from repro_torch.core.compression import KINDS, CompressionConfig
from repro_torch.core.corruption import CorruptionConfig, available_corruptions
from repro_torch.core.plan import AggregatorConfig, AsyncConfig, CohortConfig

# the flags each builder owns (the reference's inventories)
PLAN_FLAGS = (
    "--engine",
    "--buffer-size",
    "--staleness-beta",
    "--latency",
    "--latency-base-s",
    "--latency-spread",
    "--aggregator",
    "--trim-frac",
    "--dp-clip",
    "--dp-sigma",
    "--compression",
    "--topk-frac",
    "--packed-wire",
    "--error-feedback",
    "--participation",
    "--straggler-frac",
    "--straggler-keep",
    "--corrupt-kind",
    "--corrupt-rate",
    "--corrupt-scale",
)
CLIENT_EVAL_FLAGS = ("--client-eval", "--client-eval-examples")


def add_plan_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The FederatedPlan-shaping knobs, as argument groups."""
    eng = ap.add_argument_group("round engine")
    eng.add_argument("--engine", default="fedavg", choices=["fedavg", "fedsgd", "async"],
                     help="barrier FedAvg/FedSGD or the buffered-async (FedBuff-style) "
                          "streaming server")
    eng.add_argument("--buffer-size", type=int, default=0,
                     help="async: server steps when this many updates are buffered "
                          "(0 = clients-per-round)")
    eng.add_argument("--staleness-beta", type=float, default=0.5,
                     help="async: discount buffered deltas by 1/(1+s)^beta, s in server "
                          "versions since download")
    eng.add_argument("--latency", action="store_true",
                     help="price sync rounds in simulated seconds too (async always draws "
                          "arrival times)")
    eng.add_argument("--latency-base-s", type=float, default=60.0,
                     help="device-tier latency model: base upload seconds")
    eng.add_argument("--latency-spread", type=float, default=0.25,
                     help="device-tier latency model: lognormal jitter std")
    agg = ap.add_argument_group("aggregation")
    agg.add_argument("--aggregator", default="weighted_mean", choices=available_aggregators())
    agg.add_argument("--trim-frac", type=float, default=0.1,
                     help="trimmed_mean: fraction trimmed per side")
    agg.add_argument("--dp-clip", type=float, default=1.0,
                     help="clipped_mean: per-client L2 clip norm")
    agg.add_argument("--dp-sigma", type=float, default=0.0,
                     help="clipped_mean: DP Gaussian noise multiplier")
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
    cor = ap.add_argument_group("corruption")
    cor.add_argument("--corrupt-kind", default="none",
                     choices=["none", "label_shuffle"] + available_corruptions(),
                     help="adversary: a delta corruption, or label_shuffle (the data "
                          "plane's transcript shuffle)")
    cor.add_argument("--corrupt-rate", type=float, default=0.0,
                     help="P(participating client is corrupted) per round")
    cor.add_argument("--corrupt-scale", type=float, default=1.0,
                     help="adversary magnitude (sign_flip/gaussian/stale)")
    return ap


def add_client_eval_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The per-client evaluation plane (``core/clienteval.py``)."""
    ce = ap.add_argument_group("per-client evaluation")
    ce.add_argument("--client-eval", type=int, default=0,
                    help="track this many clients' per-round loss/quality and emit the "
                         "fairness spread (0 = off)")
    ce.add_argument("--client-eval-examples", type=int, default=4,
                    help="eval examples per tracked client (the client's first n "
                         "utterances, fixed across rounds)")
    return ap


def plan_kwargs(args: argparse.Namespace) -> dict:
    """The ``add_plan_args`` flags as FederatedPlan keyword arguments:
    ``FederatedPlan(clients_per_round=..., **plan_kwargs(args))``."""
    return dict(
        engine=args.engine,
        asynchrony=AsyncConfig(buffer_size=args.buffer_size,
                               staleness_beta=args.staleness_beta),
        latency=LatencyConfig(enabled=args.latency, base_s=args.latency_base_s,
                              spread=args.latency_spread),
        cohort=CohortConfig(participation=args.participation,
                            straggler_frac=args.straggler_frac,
                            straggler_keep=args.straggler_keep),
        compression=CompressionConfig(kind=args.compression, topk_frac=args.topk_frac,
                                      packed=args.packed_wire,
                                      error_feedback=args.error_feedback),
        aggregation=AggregatorConfig(name=args.aggregator, trim_frac=args.trim_frac,
                                     dp_clip=args.dp_clip, dp_sigma=args.dp_sigma),
        corruption=CorruptionConfig(kind=args.corrupt_kind, rate=args.corrupt_rate,
                                    scale=args.corrupt_scale),
    )


def plan_overrides(args: argparse.Namespace) -> dict:
    """The part of ``plan_kwargs`` the user moved off its default: each
    point of a grid keeps its own plan but for the groups the command line
    touched."""
    ref = plan_kwargs(add_plan_args(argparse.ArgumentParser(add_help=False)).parse_args([]))
    return {k: v for k, v in plan_kwargs(args).items() if v != ref[k]}
