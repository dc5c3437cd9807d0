#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

Run from a checkout of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printed as it ends:

1. the card (name and power limit, as nvidia-smi gives them);
2. the build of every CUDA kernel from the repository's sources;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the training path gives it, with its time beside its bound,
   the plain version's time and one PyTorch call of the same function;
4. one tiny FedAvg round on the card against the same round on the CPU;
5. two rounds of the paper-width RNN-T (rnnt-librispeech, 105M
   parameters) through the training entry point, with the kernels'
   launch counts over exactly that run;
6. one more such round under ``torch.profiler``: the device's busy
   share of a round and the kernels that fill it.

The line before the last is a JSON object listing every kernel; the
last is ``{"ok": true, "device": {...}}``. A failed phase raises, and
the script exits non-zero. It refuses to run without a CUDA card or
outside a checkout of the repository.
"""

from __future__ import annotations

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
    step (N=4, H=1152), a larger batch (N=32) and a ragged H (N=5, H=96),
    in bf16 and fp32 gates. Returns {kernel: row at the main path's shape}."""
    from repro_torch.kernels import lstm_gates as K
    from repro_torch.kernels import ref

    aten = torch.ops.aten
    has_lib = hasattr(aten, "_thnn_fused_lstm_cell")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for N, H in ((4, 1152), (32, 1152), (5, 96)):
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


def phase_paper_width(torch):
    """Two FedAvg rounds of rnnt-librispeech through the training entry
    point: K=4 clients, b=4, 2 local steps, FVN std 0.01."""
    from repro_torch.configs import rnnt_librispeech
    from repro_torch.core.task import get_task
    from repro_torch.kernels import lstm_gates as K
    from repro_torch.launch import train

    cfg = rnnt_librispeech.make_config()
    corpus_t = get_task(rnnt_librispeech.ARCH_ID).make_corpus(0)
    K_, b, limit, rounds = 4, 4, 8, 2
    argv = ["--preset", "arch", "--rounds", str(rounds), "--clients", str(K_),
            "--batch", str(b), "--data-limit", str(limit), "--fvn-std", "0.01"]
    torch.cuda.reset_peak_memory_stats()
    K.FWD_LAUNCHES = K.BWD_LAUNCHES = 0
    hist = train.main(argv)
    torch.cuda.synchronize()
    fwd, bwd = K.FWD_LAUNCHES, K.BWD_LAUNCHES
    if not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"paper-width losses are not finite: {hist['loss']}")
    steps = K_ * hist["local_steps"] * rounds
    per_step = cfg.enc_layers * (corpus_t.t_max // cfg.time_stride) + \
        cfg.pred_layers * (corpus_t.u_max + 1)
    if fwd == 0 or bwd == 0 or fwd != per_step * steps or bwd != per_step * steps:
        raise AssertionError(f"K1 launches fwd {fwd} bwd {bwd}, expected {per_step} per "
                             f"client step x {steps} client steps")
    per_s = [e / s for e, s in zip(hist["examples"], hist["round_s"])]
    log(f"[paper] {hist['n_params']} parameters; losses {hist['loss']}; "
        f"ms per round {[round(s * 1e3, 1) for s in hist['round_s']]}; "
        f"client examples per second {per_s}; "
        f"peak memory {torch.cuda.max_memory_allocated()} B")
    log(f"[paper] K1 launches per client step: fwd {fwd // steps}, bwd {bwd // steps} "
        f"(expected {per_step}); {steps} client steps")
    return {"lstm_gates_fwd": fwd, "lstm_gates_bwd": bwd}, hist["round_s"][-1]


def phase_profile(torch, round_s: float):
    """One more paper-width round on its own under torch.profiler, after
    the counted run: the device's kernel time against the wall time of
    the counted run's last round (the busy share), and the kernels that
    fill it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    argv = ["--preset", "arch", "--rounds", "1", "--clients", "4", "--batch", "4",
            "--data-limit", "8", "--fvn-std", "0.01"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hist = train.main(argv)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    if not by_name:
        log("[profile] the profiler recorded no device events: busy share not measured")
        return
    device_s = sum(t for t, _ in by_name.values()) / 1e6
    log(f"[profile] one round: device kernel time {device_s * 1e3:.1f} ms, "
        f"{sum(n for _, n in by_name.values())} device events; busy share "
        f"{device_s / round_s:.3f} of the unprofiled round ({round_s * 1e3:.1f} ms), "
        f"{device_s / hist['round_s'][0]:.3f} of the profiled one "
        f"({hist['round_s'][0] * 1e3:.1f} ms)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (t, n) in ranked[:8] + [kv for kv in ranked[8:] if "lstm_gates" in kv[0]]:
        log(f"[profile]   {t / 1e3:9.2f} ms  {t / 1e6 / device_s:6.3f}  {n:6d}x  {name[:100]}")


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
    phase_tiny_round(torch)
    launches, round_s = phase_paper_width(torch)
    phase_profile(torch, round_s)

    source = "src/repro_torch/kernels/csrc/lstm_gates.cu"
    replaces = {"lstm_gates_fwd": "src/repro/kernels/lstm_gates.py:43",
                "lstm_gates_bwd": "src/repro/kernels/lstm_gates.py:92"}
    kernels = [dict(name=name, route="cuda", source=source, replaces=replaces[name],
                    launches=launches[name], **rows[name]) for name in replaces]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
