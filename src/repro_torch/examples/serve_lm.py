"""Serving-path demo: batched KV-cache decoding of an assigned architecture
at its smoke config. The port's twin of ``examples/serve_lm.py``: the
architecture from the ``--arch`` registry, its smoke config's model with
random parameters from seed 0, a random prompt (numpy's generator, seed 0)
decoded token by token (every architecture's serve enters through
``decode_step``, the hybrid's has no prefill), then greedy steps. The VLM
decodes text only, as in the reference. On the card unless ``--device
cpu``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch qwen3-8b --tokens 48
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma3-4b --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.launch.train import resolve_device
from repro_torch.models.model_zoo import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.make_smoke_config()
    bundle = build_model(cfg, device=str(device))
    params = bundle.init(torch.Generator().manual_seed(0))
    vocab = cfg.vocab if hasattr(cfg, "vocab") else cfg.lm.vocab

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, vocab, (args.batch, args.prompt_len))).to(device)
    total = args.prompt_len + args.tokens

    with torch.no_grad():
        # the prompt through the decode loop: the hybrid has no batch prefill
        cache = bundle.init_cache(args.batch, total)
        t0 = time.perf_counter()
        steps = []  # every decode step's logits (B, V)
        for t in range(args.prompt_len):
            logits, cache = bundle.decode_step(params, cache, prompts[:, t:t + 1], t)
            steps.append(logits)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        out = []
        t0 = time.perf_counter()
        tok = logits.argmax(-1)[:, None]
        for t in range(args.prompt_len, total):
            out.append(tok[:, 0])
            logits, cache = bundle.decode_step(params, cache, tok, t)
            steps.append(logits)
            tok = logits.argmax(-1)[:, None]
        _sync(device)
        t_decode = time.perf_counter() - t0

    gen = torch.stack(out, 1).cpu().numpy()
    n_params = bundle.param_count(params)
    print(f"arch={args.arch} (smoke config, {n_params / 1e6:.1f}M params, {device})")
    print(f"prefill {args.prompt_len} toks x{args.batch}: {t_prefill * 1e3:.0f} ms "
          f"(through decode_step)")
    print(f"decode {args.tokens} toks x{args.batch}: "
          f"{t_decode / args.tokens * 1e3:.1f} ms/token")
    print("sample continuation ids:", gen[0][:16].tolist())
    return {"arch": args.arch, "n_params": n_params, "tokens": gen,
            "logits": torch.stack(steps).float().cpu(), "last_logits": logits.float().cpu(),
            "prefill_s": t_prefill, "decode_s": t_decode}


if __name__ == "__main__":
    main()
