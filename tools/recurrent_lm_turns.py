#!/usr/bin/env python3
"""One turn of the recurrent LMs of chip_smoke.py from the checkout given.

On one CUDA card, from the checkout at PATH (this one, or an older one
unpacked with ``git archive``), it runs what ``chip_smoke.py`` runs for
rwkv6-1.6b and zamba2-7b: the kernels' build, each model's two FedAvg
rounds and profiled round (``phase_lm_train``) and its bf16 and fp32 serves
(``phase_recurrent_serve``), and prints their lines: rounds' wall and
device times, busy shares, the path's kernels by instantiation, the
serves' times a token and device time in the profiled decode steps. Two
checkouts are compared in turns in one call, each turn its own process:

    git archive 1fd37c8 | tar -x -C build/parent_full   # any older checkout
    for t in build/parent_full . . build/parent_full; do
        python3 tools/recurrent_lm_turns.py $t
    done
"""

from __future__ import annotations

import sys
from pathlib import Path


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    tree = Path(sys.argv[1]).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("recurrent_lm_turns: no CUDA device is available")
    cs.phase_card(torch)
    from repro_torch.profile import tuner

    tuner.set_registry(tuner.TuningRegistry(path=str(tree / "build" / "chip_smoke_tuning.json")))
    cs.phase_build()
    for run, name in ((cs.RWKV_RUN, "rwkv6-1.6b"), (cs.ZAMBA_RUN, "zamba2-7b")):
        _, params, corpus = cs.phase_lm_train(torch, run)
        cs.phase_recurrent_serve(torch, name, params, corpus)
        del params, corpus
        cs._release(torch, name)
    cs.log(f"[turn] {tree}: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
