"""The paper's core idea as one picture: sweep the non-IID dial (per-
client data limit) and plot quality against CFMQ cost (Fig. 3 flavour).
The port's twin of ``examples/noniid_tradeoff.py``: a thin wrapper over
the port's sweep runner (``launch/sweeps.py``), its grid and calls, on the
card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.noniid_tradeoff --rounds 60
    PYTHONPATH=src python -m repro_torch.examples.noniid_tradeoff --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.sweeps --grid noniid_fvn  # the same runner
"""

from __future__ import annotations

import argparse

from repro_torch.launch.sweeps import run_grid


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--fvn", action="store_true", help="also sweep with FVN on")
    ap.add_argument("--smoke", action="store_true", help="tiny budget")
    ap.add_argument("--out", default="results/noniid_tradeoff_torch.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def grid_kwargs(args: argparse.Namespace) -> dict:
    """The grid and its arguments, as the reference example passes them."""
    return dict(grid="noniid_fvn", rounds=args.rounds, smoke=args.smoke, out=args.out,
                fvn_opts=(False, True) if args.fvn else (False,))


def main(argv=None) -> dict:
    args = parse_args(argv)
    frontier = run_grid(**grid_kwargs(args), device=args.device)
    for r in frontier["points"]:
        print(f"limit={str(r['limit']):>4s} fvn={r['fvn']}: "
              f"loss={r['final_loss']:.3f} wer={r['quality']:.3f} "
              f"cfmq={r['cfmq_tb']:.5f}TB{'  <- pareto' if r['pareto'] else ''}")
    print("\nsmaller limit -> closer to IID (better quality per round) but "
          "more rounds/bytes per example: the paper's §2.2 trade-off.")
    return frontier


if __name__ == "__main__":
    main()
