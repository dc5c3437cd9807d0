#!/usr/bin/env python3
"""Hold K4 (the joint backward) and K2's forward scan against the designs
before them, built from an older checkout, on one CUDA card: the same
bits, and their times in turns.

    git archive 8c01094 | tar -x -C build/k4_parent   # any commit with those designs
    python3 tools/k4_k2fwd_parent_ab.py build/k4_parent

The tool builds the older checkout's ``csrc/rnnt_joint.cu`` (K4 as two
kernels that recompute the logits, eg and w, then the reduce kernel) and
``csrc/lstm_scan.cu`` (the 256-thread forward) with this checkout's nvcc
flags, and this checkout's kernels. On inputs from a seed, as
``chip_smoke.py``'s phase 3 makes them, it requires equal bits: de, dg,
dW and db at the paper-width client step (B=4, T'=64, U1=33, J=640,
V=4,096, bf16 e and g); ys and cs at every shape phase 3 gives K2
(SCAN_SHAPES and SCAN_BWD_SHAPES, bf16 xg). At phase 3's ragged fp32
shape it requires dW and db bit for bit and prints how many de and dg
values differ: the older design rounded dh's operand at v=0 and at the
label otherwise in its fp32 instantiation than in its bf16 one, and this
design keeps the bf16 one (``dlogit_dh`` in ``csrc/rnnt_joint.cu``). Then it
prints the card's name and power limit and the eager times (CUDA events,
20 calls after a warm-up) in the order old, new, new, old: the whole K4 at
the paper width beside its plain version (``ref.rnnt_joint_bwd_ref``), and
K2's forward at the encoder (S=64) and the predictor (S=33), B=4, H=1152.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_P, _I = ctypes.c_void_p, ctypes.c_int
JOINT_SHAPES = ((4, 64, 33, 640, 4096, "bfloat16"), (3, 24, 13, 64, 64, "float32"))


def build_parent(parent: Path) -> tuple:
    """(rnnt_joint library, lstm_scan library) of the older checkout."""
    from repro_torch.kernels import build as B

    out = ROOT / "build" / "k4_k2fwd_parent"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    procs = {name: subprocess.Popen([B._nvcc(), *B.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
                                     str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in ("rnnt_joint", "lstm_scan")}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k4_k2fwd_parent_ab: nvcc exited {proc.returncode} on the older "
                             f"{name}.cu\n{log}")
    joint = ctypes.CDLL(str(out / "rnnt_joint.so"))
    joint.rnnt_joint_bwd_eg.argtypes = [_I] + [_P] * 9 + [_I] * 5 + [_P]
    joint.rnnt_joint_bwd_reduce.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    joint.rnnt_joint_bwd_w.argtypes = [_I] + [_P] * 10 + [_I] * 5 + [_P]
    scan = ctypes.CDLL(str(out / "lstm_scan.so"))
    scan.lstm_scan_fwd.argtypes = [_I] + [_P] * 7 + [_I] * 4 + [_P]
    for fn in (joint.rnnt_joint_bwd_eg, joint.rnnt_joint_bwd_reduce, joint.rnnt_joint_bwd_w,
               scan.lstm_scan_fwd):
        fn.restype = _I
    return joint, scan


def old_k4(torch, lib, e, g, w, b, labels, lse, dblank, dlabel):
    """(de, dg, dw, db) through the older design's three kernels."""
    B, T, J = e.shape
    U1, V = g.shape[1], w.shape[1]
    dtype = 1 if e.dtype == torch.bfloat16 else 0
    stream = torch.cuda.current_stream().cuda_stream
    dpre = torch.empty((B, T, U1, J), device="cuda")
    de, dg = torch.empty((B, T, J), device="cuda"), torch.empty((B, U1, J), device="cuda")
    dw, db = torch.empty((J, V), device="cuda"), torch.empty((V,), device="cuda")
    ptrs = [t.data_ptr() for t in (e, g, w, b, labels, lse, dblank, dlabel)]
    for what, err in (
            ("eg", lib.rnnt_joint_bwd_eg(dtype, *ptrs, dpre.data_ptr(), B, T, U1, J, V, stream)),
            ("reduce", lib.rnnt_joint_bwd_reduce(dpre.data_ptr(), de.data_ptr(), dg.data_ptr(),
                                                 B, T, U1, J, stream)),
            ("w", lib.rnnt_joint_bwd_w(dtype, *ptrs, dw.data_ptr(), db.data_ptr(), B, T, U1, J,
                                       V, stream))):
        if err:
            raise SystemExit(f"k4_k2fwd_parent_ab: the older K4 {what} launch returned {err}")
    return de, dg, dw, db


def old_fwd(torch, lib, xg, w, h0, c0):
    """(ys, cs) through the older forward kernel."""
    S, B, H = xg.shape[0], xg.shape[1], xg.shape[2] // 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ys = torch.empty((S, B, H), dtype=xg.dtype, device="cuda")
    cs = torch.empty((S, B, H), device="cuda")
    hbuf = torch.empty((2, B, H), device="cuda")
    err = lib.lstm_scan_fwd(1 if xg.dtype == torch.bfloat16 else 0, xg.data_ptr(),
                            w.data_ptr(), h0.data_ptr(), c0.data_ptr(), ys.data_ptr(),
                            cs.data_ptr(), hbuf.data_ptr(), S, B, H, -(-H // sms),
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"k4_k2fwd_parent_ab: the older forward's launch returned {err}")
    return ys, cs


def joint_inputs(torch, gen, B, T, U1, J, V, dtype):
    """K4's arguments at a shape, drawn from ``gen`` as phase 3 draws them."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    dt = getattr(torch, dtype)
    inputs = (rnd(B, T, J, scale=0.5).to(dt), rnd(B, U1, J, scale=0.5).to(dt),
              rnd(J, V, scale=J ** -0.5), rnd(V, scale=0.1),
              torch.randint(0, V, (B, U1), generator=gen, device="cuda", dtype=torch.int32))
    from repro_torch.kernels import rnnt_joint as K

    lse = K.rnnt_joint_fwd(*inputs)[2]
    return (*inputs, lse, rnd(B, T, U1), rnd(B, T, U1))


def scan_inputs(torch, gen, S, B, H):
    """K2's forward arguments at a shape, drawn as phase 3 draws them."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    return (rnd(S, B, 4 * H, scale=0.5).bfloat16(), rnd(H, 4 * H, scale=H ** -0.5),
            rnd(B, H, scale=0.1), rnd(B, H, scale=0.1))


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import lstm_scan as KS
    from repro_torch.kernels import ref
    from repro_torch.kernels import rnnt_joint as KJ

    if not torch.cuda.is_available():
        raise SystemExit("k4_k2fwd_parent_ab: no CUDA device is available")
    cs.phase_card(torch)
    joint_lib, scan_lib = build_parent(parent)
    build.build(("rnnt_joint", "lstm_scan"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, T, U1, J, V, dtype in JOINT_SHAPES:
        args = joint_inputs(torch, gen, B, T, U1, J, V, dtype)
        want, got = old_k4(torch, joint_lib, *args), KJ.rnnt_joint_bwd(*args)
        torch.cuda.synchronize()
        tag = f"B={B} T={T} U1={U1} J={J} V={V} {dtype}"
        diffs = {}
        for name, x, y in zip(("de", "dg", "dw", "db"), got, want):
            if not torch.equal(x, y):
                diffs[name] = (f"{int((x != y).sum())} of {x.numel()} values differ, by up to "
                               f"{float((x - y).abs().max()) / float(y.abs().max()):.2e} of "
                               "the largest")
        if dtype == "bfloat16" and diffs or set(diffs) - {"de", "dg"}:
            raise AssertionError(f"K4 {tag}: not the older design's bits: {diffs}")
        cs.log(f"[k4 parent] K4 {tag}: " + ("de, dg, dW, db equal the older design's bit for bit"
                                            if not diffs else "dW, db equal the older design's "
                                            f"bit for bit; {diffs}"))
        if dtype == "bfloat16":
            ms = {}
            for what, fn in (("old", lambda: old_k4(torch, joint_lib, *args)),
                             ("new", lambda: KJ.rnnt_joint_bwd(*args)),
                             ("new again", lambda: KJ.rnnt_joint_bwd(*args)),
                             ("old again", lambda: old_k4(torch, joint_lib, *args)),
                             ("plain", lambda: ref.rnnt_joint_bwd_ref(*args))):
                ms[what] = cs.cuda_ms(torch, fn, 20)
            cs.log(f"[k4 parent] K4 {tag}: ms per call eager: "
                   + ", ".join(f"{w} {v:.3f}" for w, v in ms.items()))
        del args, want, got
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, S, B, H in cs.SCAN_SHAPES + cs.SCAN_BWD_SHAPES:
        args = scan_inputs(torch, gen, S, B, H)
        want, got = old_fwd(torch, scan_lib, *args), KS.lstm_scan_fwd(*args)
        torch.cuda.synchronize()
        tag = f"{name} S={S} B={B} H={H}"
        for what, x, y in zip(("ys", "cs"), got, want):
            if not torch.equal(x, y):
                raise AssertionError(f"K2 forward {tag}: {what} differs from the older "
                                     f"design's in {int((x != y).sum())} of {x.numel()} values")
        line = f"[k4 parent] K2 forward {tag}: ys, cs equal the older design's bit for bit"
        if name in ("encoder", "predictor"):
            ms = {}
            for what, fn in (("old", lambda: old_fwd(torch, scan_lib, *args)),
                             ("new", lambda: KS.lstm_scan_fwd(*args)),
                             ("new again", lambda: KS.lstm_scan_fwd(*args)),
                             ("old again", lambda: old_fwd(torch, scan_lib, *args))):
                ms[what] = cs.cuda_ms(torch, fn, 20)
            line += "; us per call eager: " + ", ".join(f"{w} {v * 1e3:.1f}"
                                                         for w, v in ms.items())
        cs.log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
