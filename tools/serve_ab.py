#!/usr/bin/env python3
"""Compare two checkouts of the repository on one CUDA card: whisper-base's
serve (prefill, and greedy decode steps on the host clock) and the eager
cost of one K10 and one K11 call, at full width from a seed.

    python3 tools/serve_ab.py PARENT_DIR CHANGE_DIR

Each side runs in a fresh process, in the order parent, change, change,
parent, so that a drift of the host shows as a difference between the two
runs of one side. Each prints one line: the checkout, then a JSON object
of lists (3 repetitions; the first includes the warm-up). The card's name
and power limit come first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

STEPS = 30
REPS = 3


def one(root: Path) -> None:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import whisper_base
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KA
    from repro_torch.models import model_zoo

    if not torch.cuda.is_available():
        raise SystemExit("serve_ab: no CUDA device is available")
    build.build(("attention",))
    cfg = whisper_base.make_config()
    bundle = model_zoo.build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = bundle.init(gen)
    frames = torch.randn((4, 1500, cfg.d_model), generator=gen, device="cuda").to(cfg.cdtype)
    prompt = torch.tensor([cs.WHISPER_PROMPT] * 4, device="cuda")
    res = {"prefill_ms": [], "decode_ms_per_step": []}
    with torch.no_grad():
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = bundle.prefill(params, {"frames": frames, "tokens": prompt})
            torch.cuda.synchronize()
            res["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
            cache = cs._grow_cache(torch, cfg, cache, cs.SERVE_TOTAL, "cuda")
            tok = logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(STEPS):
                logits, cache = bundle.decode_step(params, cache, tok, len(cs.WHISPER_PROMPT) + i)
                tok = logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            res["decode_ms_per_step"].append((time.perf_counter() - t0) * 1e3 / STEPS)
        q = torch.randn((4, 8, 64), device="cuda").bfloat16()
        kc = torch.randn((4, cs.SERVE_TOTAL, 8, 64), device="cuda").bfloat16()
        pos = torch.full((), 3, dtype=torch.int32, device="cuda")
        res["k11_eager_us_self_pos3"] = [
            cs.cuda_ms(torch, lambda: KD.flash_decode(q, kc, kc, pos), 500) * 1e3]
        qa = torch.randn((4, 4, 8, 64), device="cuda").bfloat16()
        res["k10_eager_us_causal_prompt"] = [
            cs.cuda_ms(torch, lambda: KA.flash_attention(qa, qa, qa), 500) * 1e3]
    print(root.name, json.dumps({k: [round(x, 3) for x in v] for k, v in res.items()}),
          flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(Path(sys.argv[2]).resolve())
        return 0
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    parent, change = sys.argv[1], sys.argv[2]
    for root in (parent, change, change, parent):
        subprocess.run([sys.executable, __file__, "--one", root], check=True, timeout=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
