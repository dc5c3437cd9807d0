#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

Run from a checkout of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printed as it ends:

1. the card (name and power limit, as nvidia-smi gives them);
2. the build of every CUDA kernel from the repository's sources, one
   nvcc per source, all started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the training and decoding paths give it, with its time beside
   its bound, the plain version's time and a PyTorch yardstick: K1 (LSTM
   gates), then K3/K4 (the fused joint) at the paper-width client step
   and at a ragged small shape, with the backward run twice and held to
   the same bits;
4. one tiny FedAvg round on the card against the same round on the CPU,
   and a tiny greedy decode on both from the same parameters;
5. two rounds of the paper-width RNN-T (rnnt-librispeech, 105M
   parameters) through the training entry point, first with the
   chunked joint, then with the fused joint kernels (``use_kernel=True``),
   with the kernels' launch counts over the training rounds and over
   the final greedy-decode evaluation (WER on the clean and hard splits);
6. one more such round of each on its own under ``torch.profiler``:
   the device's busy share of a round and the kernels that fill it.

The line before the last is a JSON object listing every kernel; the
last is ``{"ok": true, "device": {...}}``. A failed phase raises, and
the script exits non-zero. It refuses to run without a CUDA card or
outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense fp32 rate (CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# gate operations per hidden unit, counted in csrc/lstm_gates.cu
# (a sigmoid is 4, a tanh 1)
FWD_OPS_PER_UNIT = 19
BWD_OPS_PER_UNIT = 40

# K3/K4 against their plain versions. Log-probs in fp32: a J-term dot
# product and a V-term log-sum-exp summed in another order, |log p| ~ 10.
JOINT_FWD_ATOL = 1e-4
# Gradients in fp32, relative to each gradient's largest entry: sums of
# V products (dh) and of B·T·U1 products (dW, db) in another order.
JOINT_BWD_REL_TOL = 1e-4

# the paper-width round of phases 5 and 6: K=4 clients, b=4, 2 local
# steps, FVN std 0.01; phase 5 ends with the final evaluation on 64
# examples of each split
PAPER_ARGV = ["--preset", "arch", "--clients", "4", "--batch", "4", "--data-limit", "8",
              "--fvn-std", "0.01", "--eval-every", "0"]
EVAL_EXAMPLES = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card(torch) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[card] set torch.backends.cuda.matmul.allow_tf32 = False and "
        "torch.backends.cudnn.allow_tf32 = False")


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    log(f"[build] {len(build.SOURCES)} source(s) ready in {time.perf_counter() - t0:.2f} s "
        f"({len(logs)} compiled now) under {build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log(f"[build] {name}: {line.strip()}")


def cuda_ms(torch, fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` back-to-back calls
    on the current stream, after a warm-up (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(torch, fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` replayed from one CUDA graph
    of ``n`` calls: the device's time, without the host's cost of
    issuing each launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * n)


def _bound(nbytes: int, ops: int):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _us(ms) -> str:
    return "n/a" if ms is None else f"{ms * 1e3:.2f}"


def _max_err(torch, got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def _assert_close(torch, got, want, gate_dtype, what):
    """Outputs in the gate dtype at that dtype's tolerance; fp32 outputs
    (the cell state and its gradient) at fp32's."""
    tol = {torch.float32: dict(rtol=0.0, atol=1e-5),
           torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}  # one bf16 ulp at |x| <= 2
    for g, w in zip(got, want):
        t = tol[gate_dtype] if g.dtype == gate_dtype else tol[torch.float32]
        torch.testing.assert_close(g.float(), w.float(), **t, msg=lambda m: f"{what}: {m}")


def phase_kernels(torch):
    """K1 forward and backward against the plain version at the full-width
    training step (N=4, H=1152), a larger batch (N=32), the decoding batch
    (N=64) and a ragged H (N=5, H=96), in bf16 and fp32 gates. Returns
    {kernel: row at the training path's shape}."""
    from repro_torch.kernels import lstm_gates as K
    from repro_torch.kernels import ref

    aten = torch.ops.aten
    has_lib = hasattr(aten, "_thnn_fused_lstm_cell")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for N, H in ((4, 1152), (32, 1152), (64, 1152), (5, 96)):
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape, dt=torch.float32, scale=1.0):
                return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

            gates, c = rnd(N, 4 * H, dt=dtype, scale=2.0), rnd(N, H)
            dh, dcn = rnd(N, H, dt=dtype), rnd(N, H)
            got_f = K.lstm_gates_fwd(gates, c)
            got_b = K.lstm_gates_bwd(gates, c, dh, dcn)
            torch.cuda.synchronize()
            want_f = ref.lstm_gates_ref(gates, c)
            want_b = ref.lstm_gates_bwd_ref(gates, c, dh, dcn)
            tag = f"N={N} H={H} {str(dtype).split('.')[1]}"
            _assert_close(torch, got_f, want_f, dtype, f"lstm_gates_fwd {tag}")
            _assert_close(torch, got_b, want_b, dtype, f"lstm_gates_bwd {tag}")
            if got_f[0].dtype != dtype or got_f[1].dtype != torch.float32 or \
                    got_b[0].dtype != dtype or got_b[1].dtype != torch.float32:
                raise AssertionError(f"{tag}: the kernels broke the dtype contract")

            # each input read once, each output written once
            gs = gates.element_size()
            fwd_bytes = N * 4 * H * gs + N * H * 4 + N * H * gs + N * H * 4
            bwd_bytes = 2 * N * 4 * H * gs + 3 * N * H * 4 + N * H * gs
            lib_f = lib_b = None  # one PyTorch call of the same function, a yardstick only
            if has_lib:
                hb = torch.zeros(4 * H, dtype=dtype, device="cuda")
                hb[H:2 * H] = 1.0  # the +1 forget-gate bias
                ib, zg, cc, dcn_l = torch.zeros_like(hb), torch.zeros_like(gates), \
                    c.to(dtype), dcn.to(dtype)
                try:
                    hy, cy, ws = aten._thnn_fused_lstm_cell(gates, zg, cc, ib, hb)
                except RuntimeError as e:
                    log(f"[kernels] {tag}: library fused cell unavailable: {e}")
                else:
                    log(f"[kernels] {tag}: library fused cell agrees to "
                        f"{_max_err(torch, (hy, cy), want_f):.2e}")

                    def lib_f():
                        return aten._thnn_fused_lstm_cell(gates, zg, cc, ib, hb)

                    def lib_b():
                        return aten._thnn_fused_lstm_cell_backward_impl(
                            dh, dcn_l, cc, cy, ws, True)
            for name, kernel, plain, lib, nbytes, ops, err in (
                ("lstm_gates_fwd", lambda: K.lstm_gates_fwd(gates, c),
                 lambda: ref.lstm_gates_ref(gates, c), lib_f, fwd_bytes,
                 FWD_OPS_PER_UNIT * N * H, _max_err(torch, got_f, want_f)),
                ("lstm_gates_bwd", lambda: K.lstm_gates_bwd(gates, c, dh, dcn),
                 lambda: ref.lstm_gates_bwd_ref(gates, c, dh, dcn), lib_b, bwd_bytes,
                 BWD_OPS_PER_UNIT * N * H, _max_err(torch, got_b, want_b)),
            ):
                t = {what: (cuda_ms(torch, fn, 1000), graph_ms(torch, fn, 200))
                     for what, fn in (("kernel", kernel), ("plain", plain), ("library", lib))
                     if fn is not None}
                t.setdefault("library", (None, None))
                bound_ms, bound_by = _bound(nbytes, ops)
                log(f"[kernels] {name} {tag}: max|err| {err:.2e}; us per call eager/graph: "
                    + ", ".join(f"{w} {_us(e)}/{_us(g)}" for w, (e, g) in t.items())
                    + f"; bound {bound_ms * 1e6:.1f} ns ({bound_by}, {nbytes} B)")
                if (N, H, dtype) == (4, 1152, torch.bfloat16):
                    rows[name] = {"max_abs_err": err, "ms": t["kernel"][0],
                                  "plain_ms": t["plain"][0], "bound_ms": bound_ms,
                                  "bound_by": bound_by, "library_ms": t["library"][0]}
    return rows


def phase_joint_kernels(torch):
    """K3 and K4 against their plain versions at the paper-width client
    step (B=4, T'=64, U1=33, J=640, V=4096; bf16 e and g, fp32 W and b)
    and at a ragged small shape (B=3, T=24, U1=13, J=64, V=64, fp32): the
    whole backward, then each of its three kernels alone. The backward
    runs twice and must give the same bits. Returns {kernel: row at the
    paper-width shape}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rnnt_joint as K

    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    rows = {}
    for B, T, U1, J, V, dtype in ((4, 64, 33, 640, 4096, torch.bfloat16),
                                  (3, 24, 13, 64, 64, torch.float32)):
        tag = f"B={B} T={T} U1={U1} J={J} V={V} {str(dtype).split('.')[1]}"
        inputs = (rnd(B, T, J, scale=0.5).to(dtype), rnd(B, U1, J, scale=0.5).to(dtype),
                  rnd(J, V, scale=J ** -0.5), rnd(V, scale=0.1),
                  torch.randint(0, V, (B, U1), generator=gen, device="cuda",
                                dtype=torch.int32))
        got_f = K.rnnt_joint_fwd(*inputs)
        bwd_args = (*inputs, got_f[2], rnd(B, T, U1), rnd(B, T, U1))
        got_b = K.rnnt_joint_bwd(*bwd_args)
        again = K.rnnt_joint_bwd(*bwd_args)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got_b, again)):
            raise AssertionError(f"rnnt_joint_bwd {tag}: two runs on the same inputs differ")
        want_f = ref.rnnt_joint_fwd_ref(*inputs)
        want_b = ref.rnnt_joint_bwd_ref(*bwd_args)
        err_f = _max_err(torch, got_f, want_f)
        if err_f > JOINT_FWD_ATOL:
            raise AssertionError(f"rnnt_joint_fwd {tag}: max|err| {err_f:.2e} > {JOINT_FWD_ATOL}")
        abs_b, rel_b = {}, {}
        for name, x, y in zip(("de", "dg", "dw", "db"), got_b, want_b):
            abs_b[name] = float((x - y).abs().max())
            rel_b[name] = abs_b[name] / (float(y.abs().max()) + 1e-30)
        if max(rel_b.values()) > JOINT_BWD_REL_TOL:
            raise AssertionError(f"rnnt_joint_bwd {tag}: error relative to max {rel_b} > "
                                 f"{JOINT_BWD_REL_TOL}")
        log(f"[kernels] rnnt_joint {tag}: fwd max|err| {err_f:.2e} (tol {JOINT_FWD_ATOL}); "
            f"bwd |err|/max " + ", ".join(f"{k} {v:.2e}" for k, v in rel_b.items())
            + f" (tol {JOINT_BWD_REL_TOL}); backward bitwise repeatable")
        # the backward's kernels one by one: eg gives dpre, reduce sums it
        # (each held to the plain version on the same input), w gives dW, db
        dpre = ref.rnnt_joint_bwd_dpre_ref(*bwd_args)
        parts = {"rnnt_joint_bwd_eg": ((K._bwd_eg(*bwd_args),), (dpre,)),
                 "rnnt_joint_bwd_reduce": (K._bwd_reduce(dpre),
                                           ref.rnnt_joint_bwd_reduce_ref(dpre))}
        err_part = {}
        for name, (got, want) in parts.items():
            err_part[name] = _max_err(torch, got, want)
            rel = max(float((x - y).abs().max()) / (float(y.abs().max()) + 1e-30)
                      for x, y in zip(got, want))
            if rel > JOINT_BWD_REL_TOL:
                raise AssertionError(f"{name} {tag}: error relative to max {rel:.2e} > "
                                     f"{JOINT_BWD_REL_TOL}")
            log(f"[kernels] {name} {tag}: |err|/max {rel:.2e} (tol {JOINT_BWD_REL_TOL})")

        # bytes: each input read once, each output written once; operations:
        # the products (the forward's (N x J)(J x V), the backward's two each)
        N = B * T * U1
        in_bytes = (B * T * J + B * U1 * J) * inputs[0].element_size() + (J * V + V) * 4 \
            + B * U1 * 4
        lattice = N * 4
        n_eager, n_graph = (20, 10) if N * J * V > 10**9 else (200, 100)
        h = rnd(N, J).tanh()
        t_prod = (cuda_ms(torch, lambda: torch.matmul(h, inputs[2]), n_eager),
                  graph_ms(torch, lambda: torch.matmul(h, inputs[2]), n_graph))
        log(f"[kernels] rnnt_joint {tag}: yardstick, the ({N} x {J})(x {V}) fp32 product "
            f"alone (torch.matmul, TF32 off): us per call eager/graph "
            f"{_us(t_prod[0])}/{_us(t_prod[1])}")
        for name, kernel, plain, nbytes, ops, err in (
            ("rnnt_joint_fwd", lambda: K.rnnt_joint_fwd(*inputs),
             lambda: ref.rnnt_joint_fwd_ref(*inputs), in_bytes + 3 * lattice, 2 * N * J * V,
             err_f),
            ("rnnt_joint_bwd_eg", lambda: K._bwd_eg(*bwd_args),
             lambda: ref.rnnt_joint_bwd_dpre_ref(*bwd_args),
             in_bytes + 3 * lattice + N * J * 4, 4 * N * J * V,
             err_part["rnnt_joint_bwd_eg"]),
            ("rnnt_joint_bwd_reduce", lambda: K._bwd_reduce(dpre),
             lambda: ref.rnnt_joint_bwd_reduce_ref(dpre),
             (N + B * T + B * U1) * J * 4, 2 * N * J, err_part["rnnt_joint_bwd_reduce"]),
            ("rnnt_joint_bwd_w", lambda: K._bwd_w(*bwd_args),
             lambda: ref.rnnt_joint_bwd_w_ref(*bwd_args),
             in_bytes + 3 * lattice + (J * V + V) * 4, 4 * N * J * V,
             max(abs_b["dw"], abs_b["db"])),
        ):
            t = {what: (cuda_ms(torch, fn, n_eager), graph_ms(torch, fn, n_graph))
                 for what, fn in (("kernel", kernel), ("plain", plain))}
            bound_ms, bound_by = _bound(nbytes, ops)
            log(f"[kernels] {name} {tag}: max|err| {err:.2e}; us per call eager/graph: "
                + ", ".join(f"{w} {_us(e)}/{_us(g)}" for w, (e, g) in t.items())
                + f"; bound {bound_ms * 1e3:.2f} us ({bound_by}, {ops} flop, {nbytes} B); "
                f"graph time / bound {t['kernel'][1] / bound_ms:.2f}")
            if dtype == torch.bfloat16:
                rows[name] = {"max_abs_err": err, "ms": t["kernel"][0],
                              "plain_ms": t["plain"][0], "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": None}
    return rows


def phase_tiny_round(torch):
    """One tiny FedAvg round (fp32) on the card and on the CPU from the
    same parameters and batch: the loss and the aggregated delta agree."""
    from repro_torch.core.engine import build_round_engine
    from repro_torch.core.plan import FederatedPlan
    from repro_torch.core.task import get_task
    from repro_torch.data import FederatedSampler

    task = get_task("asr-rnnt")
    plan = FederatedPlan(clients_per_round=2, local_batch_size=2, data_limit=4,
                         client_lr=0.05, server_optimizer="sgd", server_lr=1.0)
    params = task.init_params(torch.Generator().manual_seed(0))
    batch = FederatedSampler(task.make_corpus(0), 2, 2, data_limit=4, seed=0) \
        .next_round().engine_batch()
    out = {}
    for device in ("cuda", "cpu"):
        p = {k: v.to(device) for k, v in params.items()}
        engine = build_round_engine(plan, task, seed=1)
        state, metrics = engine.step(engine.init_state(p),
                                     {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        # server SGD with lr 1: the round's update is minus the aggregated delta
        out[device] = (metrics["loss"], {k: (p[k] - state.params[k]).cpu() for k in p})
    (loss_c, delta_c), (loss_h, delta_h) = out["cuda"], out["cpu"]
    if not math.isclose(loss_c, loss_h, rel_tol=1e-4):
        raise AssertionError(f"tiny round loss: cuda {loss_c} vs cpu {loss_h}")
    err = max(float((delta_c[k] - delta_h[k]).abs().max()) for k in delta_c)
    if err > 1e-5:
        raise AssertionError(f"tiny round aggregated delta differs by {err:.2e} (> 1e-5)")
    log(f"[tiny] loss cuda {loss_c:.6f} cpu {loss_h:.6f}; aggregated delta max|err| {err:.2e}")


def phase_tiny_decode(torch):
    """Greedy decoding of the tiny config (fp32) on the card and on the
    CPU from the same parameters: the token ids are identical."""
    from repro_torch.core.task import get_task
    from repro_torch.models import rnnt

    task = get_task("asr-rnnt")
    params = task.init_params(torch.Generator().manual_seed(0))
    ev = task.make_corpus(0).eval_split(16)
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = rnnt.greedy_decode(
            task.config, {k: v.to(device) for k, v in params.items()},
            torch.from_numpy(ev["features"]).to(device),
            torch.from_numpy(ev["frame_len"]).to(device)).cpu()
    if not torch.equal(out["cuda"], out["cpu"]):
        raise AssertionError("tiny greedy decode: token ids differ between cuda and cpu")
    log(f"[tiny] greedy decode of 16 eval examples: identical token ids on cuda and cpu "
        f"({int((out['cpu'] != 0).sum())} tokens emitted)")


def _paper_task(use_kernel: bool):
    from repro_torch.configs import rnnt_librispeech
    from repro_torch.core.task import get_task

    task = get_task(rnnt_librispeech.ARCH_ID)
    return dataclasses.replace(task, config=dataclasses.replace(task.config,
                                                                use_kernel=use_kernel))


def phase_paper_width(torch, use_kernel: bool):
    """Two FedAvg rounds of rnnt-librispeech through the training entry
    point, then its final evaluation. The counts are set to 0 before the
    run, read after the last round (training) and again at the end (the
    evaluation). Returns ({kernel: launches over the whole run}, the
    last round's seconds)."""
    from repro_torch.kernels import lstm_gates as K1
    from repro_torch.kernels import rnnt_joint as KJ
    from repro_torch.launch import train

    task = _paper_task(use_kernel)
    cfg, rounds = task.config, 2
    corpus = task.make_corpus(0)
    args = train.parse_args(PAPER_ARGV + ["--rounds", str(rounds)])
    tag = f"[paper use_kernel={use_kernel}]"

    def counts():
        return {"lstm_gates_fwd": K1.FWD_LAUNCHES, "lstm_gates_bwd": K1.BWD_LAUNCHES,
                "rnnt_joint_fwd": KJ.FWD_LAUNCHES, "rnnt_joint_bwd_eg": KJ.BWD_EG_LAUNCHES,
                "rnnt_joint_bwd_reduce": KJ.BWD_REDUCE_LAUNCHES,
                "rnnt_joint_bwd_w": KJ.BWD_W_LAUNCHES}

    marks = []

    def after_round(line):
        log(f"{tag} {line}")
        marks.append((counts(), torch.cuda.max_memory_allocated()))

    torch.cuda.reset_peak_memory_stats()
    K1.FWD_LAUNCHES = K1.BWD_LAUNCHES = KJ.FWD_LAUNCHES = KJ.BWD_EG_LAUNCHES = \
        KJ.BWD_REDUCE_LAUNCHES = KJ.BWD_W_LAUNCHES = 0
    _, hist = train.run_federated(task, corpus, train.build_plan(args), rounds, seed=args.seed,
                                  device="cuda", eval_every=args.eval_every,
                                  eval_examples=EVAL_EXAMPLES, log=after_round)
    torch.cuda.synchronize()
    total = counts()
    trained, train_peak = marks[-1]
    evaluated = {k: total[k] - trained[k] for k in total}

    if not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"{tag} losses are not finite: {hist['loss']}")
    steps = args.clients * hist["local_steps"] * rounds
    t_enc = corpus.t_max // cfg.time_stride
    per_step = cfg.enc_layers * t_enc + cfg.pred_layers * (corpus.u_max + 1)
    joint = steps if use_kernel else 0  # one launch of each joint kernel per client step
    want = {"lstm_gates_fwd": per_step * steps, "lstm_gates_bwd": per_step * steps,
            "rnnt_joint_fwd": joint, "rnnt_joint_bwd_eg": joint,
            "rnnt_joint_bwd_reduce": joint, "rnnt_joint_bwd_w": joint}
    if trained != want:
        raise AssertionError(f"{tag} launches over the training rounds {trained}, expected "
                             f"{want} ({steps} client steps)")
    per_decode = cfg.enc_layers * t_enc + cfg.pred_layers * (1 + t_enc * 4)
    want_eval = {k: 0 for k in want}
    want_eval["lstm_gates_fwd"] = 2 * per_decode
    if evaluated != want_eval:
        raise AssertionError(f"{tag} launches over the evaluation {evaluated}, expected "
                             f"{want_eval}")
    wers = (hist["quality"], hist["quality_hard"])
    if not all(math.isfinite(x) and x >= 0 for x in wers):
        raise AssertionError(f"{tag} WER is not a finite non-negative number: {wers}")
    per_s = [e / s for e, s in zip(hist["examples"], hist["round_s"])]
    log(f"{tag} {hist['n_params']} parameters; losses {hist['loss']}; "
        f"ms per round {[round(s * 1e3, 1) for s in hist['round_s']]}; "
        f"client examples per second {per_s}; peak memory over the training rounds "
        f"{train_peak} B")
    log(f"{tag} launches per client step over {steps} client steps: "
        + ", ".join(f"{k} {v / steps:g}" for k, v in trained.items()))
    log(f"{tag} final evaluation ({EVAL_EXAMPLES} examples of each split): "
        f"{hist['eval_s'] * 1e3:.1f} ms, WER {wers[0]:.4f} clean, {wers[1]:.4f} hard; "
        f"launches {evaluated} (lstm_gates_fwd expected {per_decode} per decode); "
        f"peak memory {torch.cuda.max_memory_allocated()} B")
    return total, hist["round_s"][-1]


def phase_profile(torch, round_s: float, use_kernel: bool):
    """One more paper-width round on its own under torch.profiler, with
    no final evaluation: the device's kernel time against the wall time
    of the counted run's last round (the busy share), and the kernels
    that fill it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    task = _paper_task(use_kernel)
    args = train.parse_args(PAPER_ARGV + ["--rounds", "1"])
    tag = f"[profile use_kernel={use_kernel}]"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, hist = train.run_federated(task, task.make_corpus(0), train.build_plan(args), 1,
                                      seed=args.seed, device="cuda", eval_every=0,
                                      eval_examples=0, log=lambda line: None)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    if not by_name:
        log(f"{tag} the profiler recorded no device events: busy share not measured")
        return
    device_s = sum(t for t, _ in by_name.values()) / 1e6
    log(f"{tag} one round: device kernel time {device_s * 1e3:.1f} ms, "
        f"{sum(n for _, n in by_name.values())} device events; busy share "
        f"{device_s / round_s:.3f} of the unprofiled round ({round_s * 1e3:.1f} ms), "
        f"{device_s / hist['round_s'][0]:.3f} of the profiled one "
        f"({hist['round_s'][0] * 1e3:.1f} ms)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    ours = [kv for kv in ranked if "lstm_gates" in kv[0] or "joint_" in kv[0]]
    for name, (t, n) in ranked[:8] + [kv for kv in ours if kv not in ranked[:8]]:
        log(f"{tag}   {t / 1e3:9.2f} ms  {t / 1e6 / device_s:6.3f}  {n:6d}x  {name[:100]}")
    share = sum(t for _, (t, _) in ours) / 1e6 / device_s
    log(f"{tag} the hand-written kernels' share of device time: {share:.3f}")


def main() -> int:
    try:
        import torch
    except ImportError:
        raise SystemExit("chip_smoke: torch is not installed")
    phase_card(torch)
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {__file__}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    rows = phase_kernels(torch)
    rows.update(phase_joint_kernels(torch))
    phase_tiny_round(torch)
    phase_tiny_decode(torch)
    _, round_s_chunked = phase_paper_width(torch, use_kernel=False)
    launches, round_s_fused = phase_paper_width(torch, use_kernel=True)
    phase_profile(torch, round_s_chunked, use_kernel=False)
    phase_profile(torch, round_s_fused, use_kernel=True)

    gates, joint = "src/repro_torch/kernels/csrc/lstm_gates.cu", \
        "src/repro_torch/kernels/csrc/rnnt_joint.cu"
    table = {  # kernel: (source, the TPU kernel it replaces)
        "lstm_gates_fwd": (gates, "src/repro/kernels/lstm_gates.py:43"),
        "lstm_gates_bwd": (gates, "src/repro/kernels/lstm_gates.py:92"),
        "rnnt_joint_fwd": (joint, "src/repro/kernels/rnnt_joint.py:86"),
        "rnnt_joint_bwd_eg": (joint, "src/repro/kernels/rnnt_joint.py:175"),
        # the de/dg sums of _bwd_eg_kernel's last step and of the dg partials
        "rnnt_joint_bwd_reduce": (joint, "src/repro/kernels/rnnt_joint.py:211"),
        "rnnt_joint_bwd_w": (joint, "src/repro/kernels/rnnt_joint.py:218"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches[name], **rows[name])
               for name, (src, replaces) in table.items()]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels of the main path never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
