#!/usr/bin/env python3
"""Hold K3 (the joint forward), K8 (the top-k scatter-add) and K9 (the
top-k unpack) against the designs before them, built from an older
checkout, on one CUDA card: the same bits, and their times in turns.

    git archive 2eaeff6 | tar -x -C build/k3_parent   # any commit with those designs
    python3 tools/k3_k8_parent_ab.py build/k3_parent

The tool builds the older checkout's ``csrc/rnnt_joint.cu`` (K3 as one
kernel a 32-point tile, h in shared memory) and ``csrc/wire_pack.cu`` (K8
behind a stable sort and a searchsorted on the host side of the launch;
K9 with one histogram of at most 36 Ki windows) with this checkout's nvcc
flags, and this checkout's kernels. On inputs from a seed it requires
equal bits: blank, label and lse at chip_smoke.py's JOINT_SHAPES (the
paper-width client step, a ragged fp32 shape, a J that is not a multiple
of 4); K8's sum at chip_smoke.py's WIRE_SIZES (K=4, 5 % a row, the
clients' picks shared as a round's deltas share them) and at n=10**8 (1 %
a row); K9's rows at the largest leaf, on a payload with repeated,
out-of-range and window-edge indices, and at n=75,497,472, the older
design's last n. Then it prints the card's name and power limit and the
eager times (CUDA events, 20 calls after a warm-up) in the order old,
new, new, old: K3 at the paper width beside its plain version and the
fp32 ``torch.matmul`` of its logits' product, K8 and K9 at the largest
leaf as the path calls them, and K3's peak memory a call.

It also builds ``tools/k3_noscratch.cu``, K3 in one launch without the
logits' scratch (the design the port measured and did not take), holds
it to the same bits, times it in turns with the port's K3, and runs the
K2 round of ``chip_smoke.py``'s phase 5 (rnnt-librispeech on K2 with the
joint kernels, two rounds, no evaluation) with each design, for their
peak memory and losses.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_P, _I = ctypes.c_void_p, ctypes.c_int
SEGMENT = 2048


def build_parent(parent: Path) -> tuple:
    """(rnnt_joint library, wire_pack library) of the older checkout, and
    the library of tools/k3_noscratch.cu."""
    from repro_torch.kernels import build as B

    out = ROOT / "build" / "k3_k8_parent"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    sources = {"rnnt_joint": [str(csrc / "rnnt_joint.cu")],
               "wire_pack": [str(csrc / "wire_pack.cu")],
               "k3_noscratch": ["-I", str(B.CSRC), str(ROOT / "tools" / "k3_noscratch.cu")]}
    procs = {name: subprocess.Popen([B._nvcc(), *B.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
                                     *src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
             for name, src in sources.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k3_k8_parent_ab: nvcc exited {proc.returncode} on the older "
                             f"{name}.cu\n{log}")
    joint = ctypes.CDLL(str(out / "rnnt_joint.so"))
    joint.rnnt_joint_fwd.argtypes = [_I] + [_P] * 8 + [_I] * 5 + [_P]
    wire = ctypes.CDLL(str(out / "wire_pack.so"))
    wire.topk_scatter_add.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    wire.topk_unpack.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    noscratch = ctypes.CDLL(str(out / "k3_noscratch.so"))
    noscratch.rnnt_joint_fwd_fused.argtypes = [_I] + [_P] * 8 + [_I] * 5 + [_P]
    for fn in (joint.rnnt_joint_fwd, wire.topk_scatter_add, wire.topk_unpack,
               noscratch.rnnt_joint_fwd_fused):
        fn.restype = _I
    return joint, wire, noscratch


def _stream(torch) -> int:
    return torch.cuda.current_stream().cuda_stream


def _ok(err: int, what: str) -> None:
    if err:
        raise SystemExit(f"k3_k8_parent_ab: the older {what} launch returned {err}")


def old_k3(torch, lib, e, g, w, b, labels):
    """(blank, label, lse) through the older forward kernel."""
    B, T, J = e.shape
    U1, V = g.shape[1], w.shape[1]
    outs = [torch.empty((B, T, U1), device="cuda") for _ in range(3)]
    _ok(lib.rnnt_joint_fwd(1 if e.dtype == torch.bfloat16 else 0,
                           *[t.data_ptr() for t in (e, g, w, b, labels, *outs)],
                           B, T, U1, J, V, _stream(torch)), "K3")
    return tuple(outs)


def noscratch_k3(torch, lib, e, g, w, b, labels):
    """(blank, label, lse) through tools/k3_noscratch.cu."""
    B, T, J = e.shape
    U1, V = g.shape[1], w.shape[1]
    outs = [torch.empty((B, T, U1), device="cuda") for _ in range(3)]
    err = lib.rnnt_joint_fwd_fused(1 if e.dtype == torch.bfloat16 else 0,
                                   *[t.data_ptr() for t in (e, g, w, b, labels, *outs)],
                                   B, T, U1, J, V, _stream(torch))
    if err:
        raise SystemExit(f"k3_k8_parent_ab: the no-scratch K3 launch returned {err}")
    return tuple(outs)


def k2_round_peaks(torch, cs, KJ, designs: dict) -> None:
    """The K2 round of chip_smoke.py's phase 5 (two rounds, no evaluation)
    with each K3 design in ``designs`` in turn in the joint's autograd
    Function: the peak memory over the rounds and the losses."""
    from repro_torch.launch import train

    cs._dispatch("auto")
    task = cs._paper_task(True)
    args = train.parse_args(cs.PAPER_ARGV + ["--rounds", "2"])
    port = KJ.rnnt_joint_fwd
    try:
        for what, fwd in designs.items():
            KJ.rnnt_joint_fwd = fwd  # RNNTJointFn.forward looks it up at each call
            corpus = task.make_corpus(0)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _, hist = train.run_federated(task, corpus, train.build_plan(args), 2,
                                          seed=args.seed, device="cuda", eval_every=0,
                                          eval_examples=0, log=lambda line: None)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            cs.log(f"[k3 parent] the K2 round with K3 {what}: peak memory over 2 rounds {peak} "
                   f"B ({peak - held} B above the {held} B held before); losses {hist['loss']}; "
                   f"ms per round {[round(x * 1e3, 1) for x in hist['round_s']]}")
    finally:
        KJ.rnnt_joint_fwd = port


def old_k8(torch, lib, values, idx, weights, n: int):
    """The older K8 as its wrapper called it: the weighted values sorted
    by index with a stable sort, each window's first entry by
    searchsorted, then the kernel."""
    flat_vals = (weights.float()[:, None] * values.float()).reshape(-1)
    flat_idx = idx.reshape(-1).to(torch.int32)
    order = torch.argsort(flat_idx, stable=True)
    starts = torch.arange((n + SEGMENT - 1) // SEGMENT + 1, dtype=torch.int32,
                          device="cuda") * SEGMENT
    si = flat_idx[order].contiguous()
    bounds = torch.searchsorted(si, starts, out_int32=True)
    sv = flat_vals[order].contiguous()
    out = torch.empty(n, device="cuda")
    _ok(lib.topk_scatter_add(sv.data_ptr(), si.data_ptr(), bounds.data_ptr(), out.data_ptr(), n,
                             SEGMENT, _stream(torch)), "K8")
    return out


def old_k9(torch, lib, W, values, idx, n: int):
    """(K, n) through the older K9 (the scratch is sized as today's)."""
    K, k = values.shape
    scratch = torch.empty(W._scratch_parts(K, k, n)[1], dtype=torch.int32, device="cuda")
    out = torch.empty((K, n), device="cuda")
    _ok(lib.topk_unpack(values.data_ptr(), idx.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                        K, k, n, SEGMENT, _stream(torch)), "K9")
    return out


def _same(torch, got, want, what: str) -> None:
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for i, (x, y) in enumerate(zip(got, want)):
        if x.shape != y.shape or not torch.equal(x, y):
            bad = int((x != y).sum()) if x.shape == y.shape else -1
            raise AssertionError(f"{what}: output {i} differs from the older design's in {bad} "
                                 f"of {y.numel()} values")


def _turns(torch, cs, old, new, n: int = 20) -> dict:
    """Eager ms a call of two versions of a function in the order old,
    new, new, old."""
    return {what: cs.cuda_ms(torch, fn, n) for what, fn in
            (("old", old), ("new", new), ("new again", new), ("old again", old))}


def _topk_payload(torch, gen, K: int, n: int, frac: float):
    """As chip_smoke.py's phase 3: correlated client rows, each one's
    top frac by magnitude (distinct within a row, shared across rows)."""
    base = torch.randn(n, generator=gen, device="cuda") * 1e-3
    x = base + torch.randn((K, n), generator=gen, device="cuda") * 2e-4
    k = max(1, min(n, math.ceil(frac * n)))
    idx = torch.topk(x.abs(), k, dim=1).indices
    return torch.gather(x, 1, idx), idx.to(torch.int32)


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import rnnt_joint as KJ
    from repro_torch.kernels import wire_pack as W

    if not torch.cuda.is_available():
        raise SystemExit("k3_k8_parent_ab: no CUDA device is available")
    cs.phase_card(torch)
    joint_lib, wire_lib, noscratch_lib = build_parent(parent)
    build.build(("rnnt_joint", "wire_pack"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, T, U1, J, V, dname in cs.JOINT_SHAPES:
        dt = getattr(torch, dname)
        args = ((torch.randn((B, T, J), generator=gen, device="cuda") * 0.5).to(dt),
                (torch.randn((B, U1, J), generator=gen, device="cuda") * 0.5).to(dt),
                torch.randn((J, V), generator=gen, device="cuda") * J ** -0.5,
                torch.randn((V,), generator=gen, device="cuda") * 0.1,
                torch.randint(0, V, (B, U1), generator=gen, device="cuda", dtype=torch.int32))
        tag = f"B={B} T={T} U1={U1} J={J} V={V} {dname}"
        want, got = old_k3(torch, joint_lib, *args), KJ.rnnt_joint_fwd(*args)
        fused = noscratch_k3(torch, noscratch_lib, *args)
        torch.cuda.synchronize()
        _same(torch, got, want, f"K3 {tag}")
        _same(torch, fused, want, f"K3 without scratch {tag}")
        line = (f"[k3 parent] K3 {tag}: blank, label, lse equal the older design's bit for bit, "
                "with the logits scratch and without")
        if B * T * U1 * J * V > 10**9:
            h2 = KJ._fwd_h(*args[:2], U1).reshape(-1, J)
            ms = _turns(torch, cs, lambda: old_k3(torch, joint_lib, *args),
                        lambda: KJ.rnnt_joint_fwd(*args))
            # the design without scratch, in turns with the port's
            turns = _turns(torch, cs, lambda: KJ.rnnt_joint_fwd(*args),
                           lambda: noscratch_k3(torch, noscratch_lib, *args))
            ms.update({w.replace("old", "port").replace("new", "without scratch"): v
                       for w, v in turns.items()})
            ms["plain"] = cs.cuda_ms(torch, lambda: ref.rnnt_joint_fwd_ref(*args), 5)
            ms["torch.matmul of h·W"] = cs.cuda_ms(torch, lambda: torch.matmul(h2, args[2]), 20)
            del h2
            peaks = {}
            for what, fn in (("old", lambda: old_k3(torch, joint_lib, *args)),
                             ("new", lambda: KJ.rnnt_joint_fwd(*args)),
                             ("without scratch",
                              lambda: noscratch_k3(torch, noscratch_lib, *args))):
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                peaks[what] = torch.cuda.max_memory_allocated() - held
            line += ("; ms per call eager: " + ", ".join(f"{w} {v:.3f}" for w, v in ms.items())
                     + "; peak memory a call above what was held: "
                     + ", ".join(f"{w} {v} B" for w, v in peaks.items()))
        cs.log(line)
        del args, want, got

    gen = torch.Generator(device="cuda").manual_seed(3)
    weights = torch.tensor([4.0, 2.0, 3.0, 1.0], device="cuda")
    for n in cs.WIRE_SIZES:
        vals, idx = _topk_payload(torch, gen, cs.WIRE_CLIENTS, n, cs.WIRE_TOPK_FRAC)
        tag = f"K={cs.WIRE_CLIENTS} k={idx.shape[1]} n={n}"
        _same(torch, W.topk_scatter_add(vals, idx, weights, n),
              old_k8(torch, wire_lib, vals, idx, weights, n), f"K8 {tag}")
        _same(torch, W.topk_unpack(vals, idx, n), old_k9(torch, wire_lib, W, vals, idx, n),
              f"K9 {tag}")
        dup = cs._unpack_edge_payload(torch, gen, cs.WIRE_CLIENTS, idx.shape[1], n, SEGMENT)
        dvals = torch.randn(dup.shape, generator=gen, device="cuda")
        _same(torch, W.topk_unpack(dvals, dup, n), old_k9(torch, wire_lib, W, dvals, dup, n),
              f"K9 with duplicate, out-of-range and window-edge indices {tag}")
        line = (f"[k3 parent] {tag}: K8, and K9 (also with duplicate, out-of-range and "
                "window-edge indices), equal the older design's bit for bit")
        if n == cs.WIRE_SIZES[0]:
            k8 = _turns(torch, cs, lambda: old_k8(torch, wire_lib, vals, idx, weights, n),
                        lambda: W.topk_scatter_add(vals, idx, weights, n))
            k9 = _turns(torch, cs, lambda: old_k9(torch, wire_lib, W, vals, idx, n),
                        lambda: W.topk_unpack(vals, idx, n))
            line += ("; us per call eager, K8 as the path calls it: "
                     + ", ".join(f"{w} {v * 1e3:.1f}" for w, v in k8.items())
                     + "; K9: " + ", ".join(f"{w} {v * 1e3:.1f}" for w, v in k9.items()))
        cs.log(line)
        del vals, idx, dup, dvals
    n = 75_497_472  # the older K9's last n: 36 Ki windows
    idx = torch.randint(-3, n + 3, (1, 4096), generator=gen, device="cuda", dtype=torch.int32)
    vals = torch.randn((1, 4096), generator=gen, device="cuda")
    _same(torch, W.topk_unpack(vals, idx, n), old_k9(torch, wire_lib, W, vals, idx, n),
          f"K9 K=1 k=4096 n={n}")
    k9 = _turns(torch, cs, lambda: old_k9(torch, wire_lib, W, vals, idx, n),
                lambda: W.topk_unpack(vals, idx, n))
    cs.log(f"[k3 parent] K9 K=1 k=4096 n={n}: equal the older design's bit for bit; us per "
           "call eager: " + ", ".join(f"{w} {v * 1e3:.1f}" for w, v in k9.items()))
    del idx, vals
    K, n = cs.SCATTER_ADD_LARGE
    vals, idx = _topk_payload(torch, gen, K, n, 0.01)
    _same(torch, W.topk_scatter_add(vals, idx, weights, n),
          old_k8(torch, wire_lib, vals, idx, weights, n), f"K8 K={K} n={n}")
    cs.log(f"[k3 parent] K8 K={K} k={idx.shape[1]} n={n}: equal the older design's bit for bit")
    del vals, idx
    port = KJ.rnnt_joint_fwd
    k2_round_peaks(torch, cs, KJ, {
        "in three launches (the port's)": port,
        "in one launch without scratch": lambda *a: noscratch_k3(torch, noscratch_lib, *a),
        "in three launches again": port})
    return 0


if __name__ == "__main__":
    sys.exit(main())
