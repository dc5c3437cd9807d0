#!/usr/bin/env python3
"""Time the two designs of K10's tensor-core dK/dV pass against each other
on one CUDA card, at the q.k widths where the backward launches the
one-warpgroup kernel.

    python3 tools/k10_bwd_split_ab.py

``csrc/attention_bwd_wgmma.cu`` launches ``fa_bwd_dkdv_wgmma_kernel`` (one
warpgroup holds dK and dV) for ND = ceil(D / 64) <= 2 and
``fa_bwd_dkdv_split_kernel`` (two warpgroups a block, dV and dK) from ND =
FA_BWD_SPLIT_FROM_ND = 3 on. The tool builds the file twice with the
checkout's nvcc flags, as it stands and with ``-DFA_BWD_SPLIT_FROM_ND=1``
(the split kernel at every ND), prints ptxas's registers and spills of
every dK/dV instantiation, and calls both libraries' C entry on the bf16
shapes of ``chip_smoke.py``'s K10_BWD_SHAPES, inputs drawn as phase 3 draws
them and o and lse from the port's forward. At each shape: dq, dk and dv of
both held to the plain version (``ref.flash_attention_bwd_ref``) within
chip_smoke's ATTN_BWD_TOL, whether the two designs give the same bits,
then the card's name and power limit and the whole backward's µs a call in
the order one-warpgroup, split, split, one-warpgroup (eager over CUDA
events and from a CUDA graph), and each launch's device µs under
torch.profiler. At ND = 3 both builds launch the split kernel: those rows
are the control.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DESIGNS = {"one-warpgroup": (), "split": ("-DFA_BWD_SPLIT_FROM_ND=1",)}


def build_designs(cs) -> dict:
    """{design: the C entry flash_attention_bwd_wgmma of its library}."""
    from repro_torch.kernels import build as B

    out = ROOT / "build" / "k10_bwd_split"
    out.mkdir(parents=True, exist_ok=True)
    src = B.CSRC / "attention_bwd_wgmma.cu"
    procs = {d: subprocess.Popen([B._nvcc(), *B.NVCC_FLAGS, *flags, "-o", str(out / f"{d}.so"),
                                  str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
             for d, flags in DESIGNS.items()}
    entries = {}
    for design, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k10_bwd_split_ab: nvcc exited {proc.returncode} on the "
                             f"{design} build\n{text}")
        entry = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(fa_bwd_dkdv_\w+?_kernel)IL[il](\d)EL[il](\d)E", line)
                entry = f"{m.group(1)}<{m.group(2)}, {m.group(3)}>" if m else None
            elif entry and ("spill" in line or ("ptxas info" in line and "Used" in line)):
                cs.log(f"[k10 split] {design} build: {entry}: {line.strip()}")
        fn = ctypes.CDLL(str(out / f"{design}.so")).flash_attention_bwd_wgmma
        fn.argtypes = [_P] * 10 + [_I] * 7 + [_F, _I, _I, _F, _I, _P]
        fn.restype = _I
        entries[design] = fn
    return entries


def main() -> int:
    if len(sys.argv) != 1:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as KA

    cs.phase_card(torch)
    entries = build_designs(cs)
    tol = cs.ATTN_BWD_TOL["bfloat16"]
    gen = torch.Generator(device="cuda").manual_seed(26)
    for name, B, Sq, Sk, H, Kv, D, Dv, causal, window, cap, off, scale in cs.K10_BWD_SHAPES:
        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16) for sh in
                   ((B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, Dv)))
        do = torch.randn((B, Sq, H, Dv), generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=off, scale=scale)
        o, lse = KA.flash_attention_fwd_lse(q, k, v, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        nd = -(-D // 64)
        tag = f"{name} (B={B} Sq={Sq} Sk={Sk} H={H} Kv={Kv} D={D} Dv={Dv}, ND={nd})"
        args = (B, Sq, Sk, H, Kv, D, Dv, D ** -0.5 if scale is None else float(scale),
                int(bool(causal)), int(window or 0), float(cap), int(off))
        scratch = torch.empty(2 * B * H * -(-Sq // 64) * 64, dtype=torch.float32, device="cuda")

        def call(design, q=q, k=k, v=v, o=o, lse=lse, do=do, args=args, scratch=scratch):
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            build.check_launch(entries[design](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                *args, torch.cuda.current_stream().cuda_stream), design)
            return dq, dk, dv

        got = {d: call(d) for d in DESIGNS}
        torch.cuda.synchronize()
        for design, grads in got.items():
            errs = [cs._rel(torch, g, w) for g, w in zip(grads, want)]
            if max(errs) > tol:
                raise AssertionError(f"k10_bwd_split_ab: {tag}: the {design} design's dq, dk, "
                                     f"dv relative errors {errs} (tol {tol})")
            cs.log(f"[k10 split] {tag}: {design} within "
                   + ", ".join(f"{e:.2e}" for e in errs) + f" of the plain version (tol {tol})")
        same = [torch.equal(a, b) for a, b in zip(*got.values())]
        cs.log(f"[k10 split] {tag}: dq, dk, dv bitwise the same in both designs: {same}")
        n = 10 if Sq * Sk > 100_000 else 50
        times = [(d, cs.cuda_ms(torch, lambda d=d: call(d), n),
                  cs.graph_ms(torch, lambda d=d: call(d), n))
                 for d in ("one-warpgroup", "split", "split", "one-warpgroup")]
        cs.log(f"[k10 split] {tag}: us a call in turns, eager / graph: "
               + ", ".join(f"{d} {e * 1e3:.2f} / {g * 1e3:.2f}" for d, e, g in times))
        for design in DESIGNS:
            split = cs._launch_split(torch, lambda d=design: call(d), calls=20)
            cs.log(f"[k10 split] {tag}: {design} device us by launch (20 calls): "
                   + ", ".join(f"{k_} {v_:.2f}" for k_, v_ in split.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
