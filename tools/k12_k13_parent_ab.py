#!/usr/bin/env python3
"""Hold K12's and K13's backwards (WKV-6, Mamba2's scan) against the designs
before them, built from an older checkout, on one CUDA card: both within
chip_smoke.py's SCAN_KERNEL_TOL of the plain versions, and their times in
turns.

    git archive be9bc59 | tar -x -C build/k12_parent   # any commit with those designs
    python3 tools/k12_k13_parent_ab.py build/k12_parent

The tool builds the older checkout's ``csrc/wkv6.cu`` and ``csrc/ssm_scan.cu``
(each backward a (B, H)-block walk that replays every 64-step chunk into a
global scratch of B·H·64·P·P or B·H·64·P·N floats) with this checkout's nvcc
flags, and this checkout's kernels. On inputs drawn as ``chip_smoke.py``'s
phase 3 draws them, at rwkv6-1.6b's training shape (B=4, S=128, H=32, P=64)
and zamba2-7b's (B=4, S=128, H=112, P=N=64), both from this checkout's
forward checkpoints, it holds every gradient of both designs to the plain
version (``ref.wkv6_bwd_ref``, ``ref.ssm_scan_bwd_ref``). Then it prints
the card's name and power limit and each backward's µs a call in the order
old, new, new, old: eager (CUDA events around 50 calls after a warm-up) and
from a CUDA graph of the call, replayed 50 times.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_parent(parent: Path) -> tuple:
    """(wkv6 library, ssm_scan library) of the older checkout."""
    from repro_torch.kernels import build as B

    out = ROOT / "build" / "k12_k13_parent"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    procs = {name: subprocess.Popen([B._nvcc(), *B.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
                                     str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in ("wkv6", "ssm_scan")}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k12_k13_parent_ab: nvcc exited {proc.returncode} on the older "
                             f"{name}.cu\n{log}")
    wkv6 = ctypes.CDLL(str(out / "wkv6.so"))
    wkv6.wkv6_bwd.argtypes = [_P] * 16 + [_I] * 5 + [_P]
    scan = ctypes.CDLL(str(out / "ssm_scan.so"))
    scan.ssm_scan_bwd.argtypes = [_P] * 17 + [_I] * 6 + [_P]
    wkv6.wkv6_bwd.restype = scan.ssm_scan_bwd.restype = _I
    return wkv6, scan


def old_wkv6_bwd(torch, lib, r, k, v, w, u, ckpt, dy):
    """(dr, dk, dv, dw, du, dS0) through the older design's two launches."""
    B, S, H, P = r.shape
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_rows = torch.empty((B, H, P), device="cuda")
    du = torch.empty((H, P), device="cuda")
    dS0 = torch.empty((B, H, P, P), device="cuda")
    scratch = torch.empty((B * H * 64 * P * P,), device="cuda")
    err = lib.wkv6_bwd(*(t.data_ptr() for t in (r, k, v, w, u, ckpt, dy)), None,
                       *(t.data_ptr() for t in (dr, dk, dv, dw, du_rows, du, dS0, scratch)),
                       B, S, H, P, 64, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"k12_k13_parent_ab: the older wkv6_bwd returned {err}")
    return dr, dk, dv, dw, du, dS0


def old_ssm_bwd(torch, lib, x, dt, a, Bm, Cm, ckpt, dy):
    """(dx, ddt, da, dB, dC, dh0) through the older design's two launches."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    dx, ddt, da = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(a)
    dB_heads = torch.empty((B, S, H, N), device="cuda")
    dC_heads = torch.empty_like(dB_heads)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dh0 = torch.empty((B, H, P, N), device="cuda")
    scratch = torch.empty((B * H * 64 * P * N,), device="cuda")
    err = lib.ssm_scan_bwd(*(t.data_ptr() for t in (x, dt, a, Bm, Cm, ckpt, dy)), None,
                           *(t.data_ptr() for t in (dx, ddt, da, dB_heads, dC_heads, dB, dC,
                                                    dh0, scratch)),
                           B, S, H, P, N, 64, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"k12_k13_parent_ab: the older ssm_scan_bwd returned {err}")
    return dx, ddt, da, dB, dC, dh0


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssm_scan as K13
    from repro_torch.kernels import wkv6 as K12

    if not torch.cuda.is_available():
        raise SystemExit("k12_k13_parent_ab: no CUDA device is available")
    cs.phase_card(torch)
    wkv6_lib, scan_lib = build_parent(parent)
    build.build(("wkv6", "ssm_scan"))
    gen = torch.Generator(device="cuda").manual_seed(30)
    for kind, spec in (("wkv6", cs.WKV6_SHAPES[0]), ("ssm_scan", cs.SSM_SHAPES[0])):
        name, B, S, H, P = spec[:5]
        N = P if kind == "wkv6" else spec[5]
        ins, _, dy, _ = cs._scan_inputs(torch, gen, kind, B, S, H, P, N, False)
        if kind == "wkv6":
            ckpt = K12.wkv6_fwd(*ins, checkpoints=True)[2]
            old = lambda: old_wkv6_bwd(torch, wkv6_lib, *ins, ckpt, dy)  # noqa: E731
            new = lambda: K12.wkv6_bwd(*ins, ckpt, dy)  # noqa: E731
            want = ref.wkv6_bwd_ref(*ins, ckpt, dy, None, K12.CHUNK)
            names = ("dr", "dk", "dv", "dw", "du", "dS0")
        else:
            ckpt = K13.ssm_scan_fwd(*ins, checkpoints=True)[2]
            old = lambda: old_ssm_bwd(torch, scan_lib, *ins, ckpt, dy)  # noqa: E731
            new = lambda: K13.ssm_scan_bwd(*ins, ckpt, dy)  # noqa: E731
            want = ref.ssm_scan_bwd_ref(*ins, ckpt, dy, None, K13.CHUNK)
            names = ("dx", "ddt", "da", "dB", "dC", "dh0")
        tag = f"{kind} {name} (B={B} S={S} H={H} P={P}" + ("" if kind == "wkv6" else
                                                           f" N={N}") + ")"
        for design, fn in (("old", old), ("new", new)):
            got = fn()
            torch.cuda.synchronize()
            errs = {n: cs._rel(torch, g, w) for n, g, w in zip(names, got, want)}
            if max(errs.values()) > cs.SCAN_KERNEL_TOL:
                raise AssertionError(f"{tag}: the {design} design's relative errors {errs} "
                                     f"(tol {cs.SCAN_KERNEL_TOL})")
            cs.log(f"[k12 parent] {tag}: the {design} design within "
                   + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
                   + f" of the plain version (tol {cs.SCAN_KERNEL_TOL})")
        times = []
        for design, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
            times.append((design, cs.cuda_ms(torch, fn, 50), cs.graph_ms(torch, fn, 50)))
        cs.log(f"[k12 parent] {tag}: backward us a call in turns, eager / graph: "
               + ", ".join(f"{d} {e * 1e3:.2f} / {g * 1e3:.2f}" for d, e, g in times))
        del ins, dy, ckpt, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
