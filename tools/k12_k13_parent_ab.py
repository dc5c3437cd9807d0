#!/usr/bin/env python3
"""Hold K12's and K13's kernels (WKV-6, Mamba2's scan) against the designs
of an older checkout on one CUDA card: both within chip_smoke.py's
SCAN_KERNEL_TOL of the plain versions, and their times in turns.

    git archive 1fd37c8 | tar -x -C build/k12_parent   # a commit with these C entries
    python3 tools/k12_k13_parent_ab.py build/k12_parent

The tool builds the older checkout's ``csrc/wkv6.cu`` and ``csrc/ssm_scan.cu``
with this checkout's nvcc flags, and this checkout's kernels. Forwards (one
launch each, the same C interface since they came in): at rwkv6-1.6b's
training shape (B=4, S=128, H=32, P=64) and decode step (S=1 from a
state), and zamba2-7b's (H=112, P=N=64), on inputs drawn as
``chip_smoke.py``'s phase 3 draws them, it holds y, the final state and
the checkpoints of both designs to the plain version (``ref.wkv6_fwd_ref``,
``ref.ssm_scan_fwd_ref``) and prints whether the new final state and
checkpoints are the older design's bits. A training shape is called as
training calls it (with checkpoints), a decode step as the serves do
(without). Backwards, at the training shapes from this checkout's forward
checkpoints: every gradient of both designs held to the plain version
(``ref.wkv6_bwd_ref``, ``ref.ssm_scan_bwd_ref``). Then the card's
name and power limit, and each call's µs in the order old, new, new, old:
eager (CUDA events around 50 calls after a warm-up, 200 at a decode step)
and from a CUDA graph of the calls, replayed; at a decode step also each
design's device time a launch over 100 calls under torch.profiler, apart
from the gaps between launches.
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
    wkv6.wkv6_fwd.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    wkv6.wkv6_bwd.argtypes = [_P] * 15 + [_I] * 5 + [_P]
    scan = ctypes.CDLL(str(out / "ssm_scan.so"))
    scan.ssm_scan_fwd.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    scan.ssm_scan_bwd.argtypes = [_P] * 16 + [_I] * 6 + [_P]
    for fn in (wkv6.wkv6_fwd, wkv6.wkv6_bwd, scan.ssm_scan_fwd, scan.ssm_scan_bwd):
        fn.restype = _I
    return wkv6, scan


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(torch, fn, what: str, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"k12_k13_parent_ab: the older {what} returned {err}")


def old_fwd(torch, lib, kind: str, ins, state, checkpoints: bool):
    """(y, final state, checkpoints or None) through the older forward."""
    B, S, H, P = ins[0].shape
    N = P if kind == "wkv6" else ins[3].shape[-1]
    y = torch.empty_like(ins[0])
    last = torch.empty((B, H, P, N), device="cuda")
    ckpt = torch.empty((B, H, -(-S // 64), P, N), device="cuda") if checkpoints else None
    if kind == "wkv6":
        _call(torch, lib.wkv6_fwd, "wkv6_fwd", *(t.data_ptr() for t in ins), _ptr(state),
              y.data_ptr(), last.data_ptr(), _ptr(ckpt), B, S, H, P, 64)
    else:
        _call(torch, lib.ssm_scan_fwd, "ssm_scan_fwd", *(t.data_ptr() for t in ins),
              _ptr(state), y.data_ptr(), last.data_ptr(), _ptr(ckpt), B, S, H, P, N, 64)
    return y, last, ckpt


def old_wkv6_bwd(torch, lib, r, k, v, w, u, ckpt, dy):
    """(dr, dk, dv, dw, du, dS0) through the older design's two launches."""
    B, S, H, P = r.shape
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_rows = torch.empty((B, H, P), device="cuda")
    du = torch.empty((H, P), device="cuda")
    dS0 = torch.empty((B, H, P, P), device="cuda")
    _call(torch, lib.wkv6_bwd, "wkv6_bwd", *(t.data_ptr() for t in (r, k, v, w, u, ckpt, dy)),
          None, *(t.data_ptr() for t in (dr, dk, dv, dw, du_rows, du, dS0)), B, S, H, P, 64)
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
    _call(torch, lib.ssm_scan_bwd, "ssm_scan_bwd",
          *(t.data_ptr() for t in (x, dt, a, Bm, Cm, ckpt, dy)), None,
          *(t.data_ptr() for t in (dx, ddt, da, dB_heads, dC_heads, dB, dC, dh0)),
          B, S, H, P, N, 64)
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

    def turns(tag: str, what: str, old, new, n: int) -> None:
        times = [(d, cs.cuda_ms(torch, fn, n), cs.graph_ms(torch, fn, n))
                 for d, fn in (("old", old), ("new", new), ("new", new), ("old", old))]
        cs.log(f"[k12 parent] {tag}: {what} us a call in turns, eager / graph: "
               + ", ".join(f"{d} {e * 1e3:.2f} / {g * 1e3:.2f}" for d, e, g in times))

    def device_us(fn) -> float:
        from torch.profiler import ProfilerActivity, profile

        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
        times = cs._device_times(torch, prof)
        return sum(t for t, _ in times.values()) / sum(n for _, n in times.values())

    def held(tag: str, design: str, names, got, want) -> None:
        torch.cuda.synchronize()
        errs = {n: cs._rel(torch, g, w) for n, g, w in zip(names, got, want) if w is not None}
        if max(errs.values()) > cs.SCAN_KERNEL_TOL:
            raise AssertionError(f"{tag}: the {design} design's relative errors {errs} "
                                 f"(tol {cs.SCAN_KERNEL_TOL})")
        cs.log(f"[k12 parent] {tag}: the {design} design within "
               + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
               + f" of the plain version (tol {cs.SCAN_KERNEL_TOL})")

    for kind, shapes in (("wkv6", cs.WKV6_SHAPES[:2]), ("ssm_scan", cs.SSM_SHAPES[:2])):
        K = K12 if kind == "wkv6" else K13
        lib = wkv6_lib if kind == "wkv6" else scan_lib
        fwd = K12.wkv6_fwd if kind == "wkv6" else K13.ssm_scan_fwd
        fwd_ref = ref.wkv6_fwd_ref if kind == "wkv6" else ref.ssm_scan_fwd_ref
        for spec in shapes:
            name, B, S, H, P = spec[:5]
            N = P if kind == "wkv6" else spec[5]
            ins, state, dy, _ = cs._scan_inputs(torch, gen, kind, B, S, H, P, N, spec[-1])
            ck = S > 1  # training keeps checkpoints, a serve's decode step does not
            tag = f"{kind} {name} (B={B} S={S} H={H} P={P}" + ("" if kind == "wkv6" else
                                                               f" N={N}") + ")"
            want = list(fwd_ref(*ins, state, K.CHUNK))
            if not ck:
                want[2] = None
            old = old_fwd(torch, lib, kind, ins, state, ck)
            new = fwd(*ins, state, checkpoints=ck)
            for design, got in (("old", old), ("new", new)):
                held(tag + " forward", design, ("y", "state", "checkpoints"), got, want)
            same = [torch.equal(o, n_) for o, n_ in zip(old[1:], new[1:]) if o is not None]
            cs.log(f"[k12 parent] {tag} forward: the new final state"
                   + (" and checkpoints" if ck else "") + " bitwise the old design's: "
                   + ("yes" if all(same) else f"no ({same})")
                   + f"; y bitwise: {'yes' if torch.equal(old[0], new[0]) else 'no'}")
            old_f = lambda: old_fwd(torch, lib, kind, ins, state, ck)  # noqa: E731
            new_f = lambda: fwd(*ins, state, checkpoints=ck)  # noqa: E731
            turns(tag, "forward", old_f, new_f, 50 if ck else 200)
            if not ck:
                cs.log(f"[k12 parent] {tag}: forward device us a launch (profiler, 100 "
                       f"launches): old {device_us(old_f):.2f}, new {device_us(new_f):.2f}")
                continue
            ckpt = new[2]
            if kind == "wkv6":
                old_b = lambda: old_wkv6_bwd(torch, lib, *ins, ckpt, dy)  # noqa: E731
                new_b = lambda: K12.wkv6_bwd(*ins, ckpt, dy)  # noqa: E731
                want_b = ref.wkv6_bwd_ref(*ins, ckpt, dy, None, K12.CHUNK)
                names = ("dr", "dk", "dv", "dw", "du", "dS0")
            else:
                old_b = lambda: old_ssm_bwd(torch, lib, *ins, ckpt, dy)  # noqa: E731
                new_b = lambda: K13.ssm_scan_bwd(*ins, ckpt, dy)  # noqa: E731
                want_b = ref.ssm_scan_bwd_ref(*ins, ckpt, dy, None, K13.CHUNK)
                names = ("dx", "ddt", "da", "dB", "dC", "dh0")
            for design, fn in (("old", old_b), ("new", new_b)):
                held(tag + " backward", design, names, fn(), want_b)
            turns(tag, "backward", old_b, new_b, 50)
            del want_b
        del ins, dy, want, old, new
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
