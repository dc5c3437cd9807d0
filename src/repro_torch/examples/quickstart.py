"""Quickstart: 30 federated rounds of a tiny RNN-T on the synthetic
speaker-split corpus, the paper's Alg. 1 end to end. The port's twin of
``examples/quickstart.py``: its plan and calls, on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.core.plan import FederatedPlan, FVNConfig
from repro_torch.launch.train import run_federated_asr, tiny_asr_setup

ROUNDS = 30


def make_plan() -> FederatedPlan:
    return FederatedPlan(
        clients_per_round=8,          # K
        local_batch_size=4,           # b
        local_steps=12,               # local epoch cap
        data_limit=None,              # the paper's non-IID dial (§4.2.1);
                                      # try 4 to push the round toward IID
        client_lr=0.3,                # client SGD
        server_lr=0.05,               # server Adam
        server_warmup_rounds=4,
        fvn=FVNConfig(enabled=True, std=0.02, ramp_rounds=15),  # §4.2.2
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg, corpus = tiny_asr_setup(seed=0)
    print(f"corpus: {corpus.num_speakers} speakers, {int(corpus.counts.sum())} utterances")
    _, hist = run_federated_asr(cfg, corpus, make_plan(), rounds=args.rounds, seed=0,
                                eval_every=10, eval_examples=32, device=args.device)
    print(f"\nfinal loss {hist['final_loss']:.3f}  WER {hist['quality']:.3f} "
          f"(hard {hist['quality_hard']:.3f})")
    print(f"CFMQ for this run: {hist['cfmq_tb']:.5f} TB "
          f"({hist['n_params'] / 1e6:.2f}M params, Eq. 2)")
    return hist


if __name__ == "__main__":
    main()
