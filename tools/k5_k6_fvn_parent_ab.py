#!/usr/bin/env python3
"""Hold K5 (the keyed quantizer) and K6 (the nearest and streamed
quantizers) against the designs before them, built from an older
checkout, on one CUDA card: the same bits, and their times in turns; and
time FVN's noise as the older checkout drew it (a generator's
``torch.randn`` per tensor) against the normal kernel.

    git archive 458c65a | tar -x -C build/k5_parent   # any commit with those designs
    python3 tools/k5_k6_fvn_parent_ab.py build/k5_parent

The tool builds the older checkout's ``csrc/wire_pack.cu`` (K5 hashing
each position's threefry block for it alone, K6 one element a thread)
with this checkout's nvcc flags, and this checkout's kernels. On inputs
from a seed it requires equal bits from both: every rounding (keyed,
streamed, nearest), int8 codes and int4 codes and wire bytes, a shared
scale and one a client, at chip_smoke.py's WIRE_SIZES and
QUANT_EDGE_SIZES (n = 10**8 among them). Then it prints the card's name
and power limit and the times in the order old, new, new, old (CUDA
events around 50 back-to-back calls, eager, and from one CUDA graph) at
K=4 and the paper's largest leaf (n=5,308,416) of K5 keyed int4 packed and
int8 codes, K6 nearest int8 codes and streamed int4 packed; and, at
rnnt-librispeech's 35 tensors, one client step's FVN noise both ways:
the older per-tensor path (``torch.randn`` on a seeded generator, then
``sigma *`` and ``+``: 105 launches) and ``fvn.perturb`` (the leaf keys
split on the host, one kernel launch), each eager, and its device time
under torch.profiler (the kernels' sum over one call). Last, two
paper-width runs of chip_smoke.py's phase 5 with the normal draws both
ways, in the order old, new, new, old: the K2 round (FVN 0.01, two
rounds) and the slow path's fp32 run with the DP noise and the gaussian
adversary (three rounds). The older draws are emulated in place of the
new ones: FVN from a generator's ``torch.randn`` per tensor (seeded from
the step's key, not the older seed: the same work, other values), the
adversary's and the DP noise per tensor from the int64 threefry and
``torch.erfinv``, as the older ``keys.normal``. Each prints its losses,
ms per round, the last round's device kernel time and events under
torch.profiler, and the peak memory.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_P, _I = ctypes.c_void_p, ctypes.c_int
_NEAREST, _STREAMED, _KEYED = 0, 1, 2


def build_parent(parent: Path) -> ctypes.CDLL:
    """The older checkout's wire_pack library."""
    from repro_torch.kernels import build as B

    out = ROOT / "build" / "k5_k6_parent"
    out.mkdir(parents=True, exist_ok=True)
    src = parent / "src" / "repro_torch" / "kernels" / "csrc" / "wire_pack.cu"
    lib_path = out / "wire_pack.so"
    proc = subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"k5_k6_fvn_parent_ab: nvcc exited {proc.returncode} on the older "
                         f"wire_pack.cu\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.wire_quantize.argtypes = [_I, _I, _P, _P, _I, _P, _P, _P, _I, _I, ctypes.c_float, _P]
    lib.wire_quantize.restype = _I
    return lib


def old_quantize(torch, lib, W, x, scale, u, key_data, bits: int, pack4: bool):
    """The older kernel through this checkout's wrapper's preparation."""
    K, n = x.shape
    mode = _NEAREST if u is None and key_data is None else (_KEYED if u is None else _STREAMED)
    s, stride = W._scale_tensor(scale, K, x)
    keys = None if key_data is None else W._key_words_u32(key_data, K, x.device)
    out = torch.empty((K, (n + 1) // 2 if pack4 else n), dtype=torch.int8, device=x.device)
    err = lib.wire_quantize(mode, int(pack4), x.data_ptr(), s.data_ptr(), stride,
                            None if u is None else u.data_ptr(),
                            None if keys is None else keys.data_ptr(), out.data_ptr(), K, n,
                            2.0 ** (bits - 1) - 1.0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"k5_k6_fvn_parent_ab: the older wire_quantize launch returned {err}")
    return out


def variants(torch, lib, W, x, keys, u):
    """{what: (older, this checkout's)} of every rounding, width, output
    and kind of scale."""
    out = {}
    for bits in (8, 4):
        lv = 2.0 ** (bits - 1) - 1.0
        per_client = x.abs().amax(dim=1) / lv * 0.9
        per_client[0] = 1.0
        for sname, scale in (("shared", x.abs().max() / lv * 0.9), ("per-client", per_client)):
            for rname, uu, kd in (("keyed", None, keys), ("streamed", u, None),
                                  ("nearest", None, None)):
                for pack4 in ((False, True) if bits == 4 else (False,)):
                    what = f"{rname} int{bits} {'packed' if pack4 else 'codes'} {sname} scale"

                    def new(scale=scale, uu=uu, kd=kd, bits=bits, pack4=pack4):
                        if kd is not None:
                            fn = W.quantize_pack_keyed if pack4 else W.quantize_with_scale_keyed
                            return fn(x, scale, kd, bits)
                        fn = W.quantize_pack if pack4 else W.quantize_with_scale
                        return fn(x, scale, uu, bits)

                    def old(scale=scale, uu=uu, kd=kd, bits=bits, pack4=pack4):
                        return old_quantize(torch, lib, W, x, scale, uu, kd, bits, pack4)

                    out[what] = (old, new)
    return out


def fvn_paths(torch, cs, sigma: float = 0.01):
    """(older per-tensor randn path, fvn.perturb) for one client step of
    rnnt-librispeech, as closures over its parameters on the card."""
    from repro_torch.core import fvn, keys

    params = cs._paper_task(True).init_params(torch.Generator(device="cuda").manual_seed(0))
    key = fvn.fvn_key(keys.PRNGKey(0), 1, 2, 1)
    return (lambda: older_perturb(torch, params, key, sigma),
            lambda: fvn.perturb(params, key, sigma))


def older_perturb(torch, params: dict, key, sigma: float) -> dict:
    """FVN's noise drawn as the older checkout drew it: one seeded
    generator, ``torch.randn`` per tensor in the dict's order."""
    device = next(iter(params.values())).device
    k0, k1 = (int(v) for v in key.tolist())
    g = torch.Generator(device=device).manual_seed(k0 << 32 | k1)
    return {k: (p.float() + sigma * torch.randn(p.shape, generator=g, device=device))
            .to(p.dtype) for k, p in params.items()}


def older_normal_axpy(torch, xs, key_data, scales) -> list:
    """The gaussian adversary's and the DP noise as the older checkout
    drew them: per tensor, the int64 threefry word of each position and
    ``sqrt(2) * torch.erfinv`` of its uniform (the older keys.normal)."""
    import math

    from repro_torch.kernels import ref

    out = []
    for x, kd, s in zip(xs, key_data, scales):
        n, kd = x.numel(), kd.to(x.device)
        pos = torch.arange(n, device=x.device)
        f = ref.bits_to_uniform(ref.threefry_random_bits_at(kd[0:1], kd[1:2], pos, n))
        lo = torch.tensor(ref.NORMAL_LO, dtype=torch.float32, device=x.device)
        u = torch.maximum(lo, (f.double() * 2.0 + lo.double()).float())
        z = torch.erfinv(u) * torch.tensor(math.sqrt(2.0), device=x.device)
        s = torch.as_tensor(s, dtype=torch.float32).to(x.device)
        if s.dim() == 1:
            z, s = z.reshape(s.shape[0], -1), s[:, None]
        out.append((x.float().reshape(z.shape) + s * z).reshape(x.shape).to(x.dtype))
    return out


def round_turns(torch, cs) -> None:
    """The K2 round and the slow path's DP and gaussian run with the older
    draws and the new, in turns (old, new, new, old)."""
    from repro_torch.core import fvn
    from repro_torch.kernels import threefry_normal
    from repro_torch.launch import train

    cs._dispatch("auto")
    task = cs._paper_task(True)
    dp_gaussian = next(flags for name, flags, _, _ in cs.SLOWPATH if "gaussian" in name)
    port = (fvn.perturb, threefry_normal.normal_axpy)
    older = (lambda p, k, s: older_perturb(torch, p, k, s),
             lambda xs, kd, sc: older_normal_axpy(torch, xs, kd, sc))
    try:
        for what, flags, rounds in (("the K2 round", [], 2),
                                    ("the slow path's DP and gaussian run", dp_gaussian, 3)):
            for side in ("old", "new", "new", "old"):
                fvn.perturb, threefry_normal.normal_axpy = older if side == "old" else port
                args = train.parse_args(cs.PAPER_ARGV + ["--rounds", str(rounds)] + flags)
                corpus = task.make_corpus(0)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                watch = cs._RunWatch(torch, f"[k5 parent] {what} {side}", rounds)
                _, hist = train.run_federated(task, corpus, train.build_plan(args), rounds,
                                              seed=args.seed, device="cuda", eval_every=0,
                                              eval_examples=0, log=watch)
                by_name = cs._device_times(torch, watch.prof)
                dev = sum(t for t, _ in by_name.values()) / 1e3
                events = sum(c for _, c in by_name.values())
                cs.log(f"[k5 parent] {what}, {side} draws: losses {hist['loss']}; ms per round "
                       f"{[round(x * 1e3, 1) for x in hist['round_s']]} (the last profiled); "
                       f"its device kernel time {dev:.1f} ms in {events} device events; peak "
                       f"memory {torch.cuda.max_memory_allocated()} B")
    finally:
        fvn.perturb, threefry_normal.normal_axpy = port


def device_ms(torch, fn, calls: int = 5) -> tuple:
    """(device ms a call, device events a call) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None, 0
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls, len(events) / calls


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import wire_pack as W

    if not torch.cuda.is_available():
        raise SystemExit("k5_k6_fvn_parent_ab: no CUDA device is available")
    cs.phase_card(torch)
    lib = build_parent(parent)
    build.build(("wire_pack", "threefry_normal"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    for n in cs.WIRE_SIZES + cs.QUANT_EDGE_SIZES:
        K = 2 if n > 10**7 else cs.WIRE_CLIENTS
        x = torch.randn((K, n), generator=gen, device="cuda") * 1e-3
        x[:, ::97] = 0.0
        keys = torch.randint(0, 2**32, (K, 2), generator=gen, device="cuda", dtype=torch.int64)
        u = torch.rand((K, n), generator=gen, device="cuda")
        cases = variants(torch, lib, W, x, keys, u)
        for what, (old, new) in cases.items():
            a, b = old(), new()
            if a.shape != b.shape or not torch.equal(a, b):
                bad = int((a != b).sum()) if a.shape == b.shape else -1
                raise AssertionError(f"K5/K6 {what} K={K} n={n}: {bad} of {a.numel()} bytes "
                                     "differ from the older design's")
        line = (f"[k5 parent] K={K} n={n}: {len(cases)} variants equal the older design's bit "
                "for bit")
        if n == cs.WIRE_SIZES[0]:
            parts = []
            for what in ("keyed int4 packed shared scale", "keyed int8 codes shared scale",
                         "nearest int8 codes shared scale", "streamed int4 packed shared scale"):
                old, new = cases[what]
                eager = [cs.cuda_ms(torch, fn, 50) for fn in (old, new, new, old)]
                graph = [cs.graph_ms(torch, fn, 20) for fn in (old, new, new, old)]
                parts.append(f"{what}: eager " + ", ".join(f"{t * 1e3:.1f}" for t in eager)
                             + "; graph " + ", ".join(f"{t * 1e3:.1f}" for t in graph))
            line += "; us a call, old, new, new, old: " + "; ".join(parts)
        cs.log(line)
        del x, u, cases
    older, perturb = fvn_paths(torch, cs)
    eager = [cs.cuda_ms(torch, fn, 20) for fn in (older, perturb, perturb, older)]
    dev = [device_ms(torch, fn) for fn in (older, perturb, perturb, older)]
    cs.log("[k5 parent] FVN's noise for one client step of rnnt-librispeech (35 tensors, "
           "105,333,760 fp32 values), older per-tensor randn path / fvn.perturb, in the order "
           "old, new, new, old: eager ms " + ", ".join(f"{t:.4f}" for t in eager)
           + "; device ms (torch.profiler, kernels' sum a call) "
           + ", ".join("n/a" if t is None else f"{t:.4f}" for t, _ in dev)
           + "; device events a call " + ", ".join(f"{c:g}" for _, c in dev))
    round_turns(torch, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
