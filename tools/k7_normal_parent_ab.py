#!/usr/bin/env python3
"""Hold the normal kernel and K7 (nibble pack, nibble unpack, dequantize)
against the designs before them, built from an older checkout, on one
CUDA card: the same bits, and their times in turns.

    git archive fb2a4a3 | tar -x -C build/k7_parent   # any commit with those designs
    python3 tools/k7_normal_parent_ab.py build/k7_parent
    python3 tools/k7_normal_parent_ab.py build/k7_parent --sass   # the SASS counts alone

The tool builds the older checkout's ``csrc/threefry_normal.cu`` (a thread
a threefry block, XLA's log1p as a select of both branches) and
``csrc/wire_pack.cu`` (K7 one byte or element a thread) with this
checkout's nvcc flags, and this checkout's kernels.

Two variants of this checkout's normal kernel, which its design was
chosen over, are built from copies of its source with one passage
replaced (``VARIANTS``): the select variant (4 blocks a thread, both log1p
branches a draw and XLA's select, no sort) and the 8-block variant (8
threefry blocks a thread).

``--sass`` prints, with no timing, the SASS instruction counts
(``cuobjdump -sass``) of both normal kernels, of the select variant and
of the probes in
``tools/normal_sass_probe.cu`` (one threefry block, each log1p branch,
the old select of both, erf_inv's polynomials, the uniform, a word's whole
chain in the older code, and a copy to subtract), by class of opcode and
before the first EXIT (the straight path), and whether ``ncu`` is on the
machine. ``--once`` calls each normal kernel (older, this checkout's, the
two variants) once at the paper's table, for a profiler such as ``ncu``.

Without it: on inputs from a seed it requires equal bits from both
designs: K7's three kernels at chip_smoke.py's WIRE_SIZES, K7's run edges
(``wire_pack.K7_RUN_EDGES``) and K7_LARGE at K=4 and at the run edges at
K=3 (a shared scale and one a client), and the normal kernel at
rnnt-librispeech's 35 tensors, NORMAL_RAGGED and chip_smoke's
``normal_edges``. Then it prints the card's name and power limit and the
times in the order old, new, new, old (CUDA events around back-to-back
calls, eager, and from one CUDA graph): K7 at K=4 and the paper's largest
leaf (n=5,308,416; dequantize with a scale a client, as the slow path
calls it) twice, with the same inputs every call (in L2 after the first)
and with a cold L2 (the inputs rotated over enough sets to pass 200 MB,
four times the L2), and the normal kernel at the paper's table, also
against the select variant and the 8-block variant in the order variant,
new, new, variant, whose bits it holds too. Last, two paper-width
runs of chip_smoke.py's phase 5 with the older normal kernel and the new one in
place, in the order old, new, new, old: the K2 round (FVN 0.01, two
rounds) and the slow path's fp32 run with the DP noise and the gaussian
adversary (three rounds). Each prints its losses, ms per round, the last
round's device kernel time and events under torch.profiler, the normal
kernel's share of it, and the peak memory.
"""

from __future__ import annotations

import ctypes
import itertools
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k7_normal_parent"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the L2's bytes that a cold-L2 timing's inputs pass four times over
L2_BYTES = 50 * 2**20

# the variants of this checkout's normal kernel: {name: (the passage of
# csrc/threefry_normal.cu that is replaced, its replacement)}
VARIANTS = {
    # both log1p branches a draw and XLA's select in place of the sort
    "select": (re.compile(r"  const int lane = threadIdx\.x % 32;\n.*?"
                          r"  __syncwarp\(\);  // the list is free again\n", re.S),
               "#pragma unroll\n"
               "  for (int j = 0; j < kDraws; ++j) {\n"
               "    const float y = __fmul_rn(u[j], -u[j]);\n"
               "    lg[j] = fabsf(y) < kCephesBelow ? log1p_cephes(y) : log1p_eigen(y);\n"
               "  }\n"),
    # 8 threefry blocks a thread
    "pairs8": (re.compile(r"constexpr int kPairs = 4;"), "constexpr int kPairs = 8;"),
}

# SASS opcodes by class (the first word of the opcode)
_CLASSES = (
    ("int32", {"IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR", "IMAD",
               "IMNMX", "ISETP", "LEA", "IABS", "PRMT", "SEL", "POPC", "FLO", "BREV", "BMSK",
               "VIADD", "VIMNMX", "IDP", "VABSDIFF4", "IMUL"}),
    ("fp32", {"FFMA", "FMUL", "FADD", "FSETP", "FSEL", "FMNMX", "FCHK", "MUFU", "I2F", "F2I",
              "F2F", "FRND", "FSET", "FSWZADD", "F2FP", "HADD2", "HFMA2", "HMUL2"}),
    ("memory", {"LDG", "STG", "LDS", "STS", "LDC", "LD", "ST", "LDL", "STL", "LDSM"}),
    ("warp", {"VOTE", "VOTEU", "SHFL", "BAR", "WARPSYNC", "MATCH", "REDUX"}),
    ("control", {"BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BREAK", "BPT", "JMP", "YIELD",
                 "NANOSLEEP", "BMOV", "ACQBULK"}),
)


def _nvcc(*args) -> None:
    from repro_torch.kernels import build as B

    proc = subprocess.run([B._nvcc(), *args], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"k7_normal_parent_ab: nvcc exited {proc.returncode}\n"
                         f"{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line) or "spill" in line:
            print(f"[k7 parent] ptxas: {line.strip()}", flush=True)


def variant_source(name: str) -> Path:
    """A copy of this checkout's csrc/threefry_normal.cu with VARIANTS[name]'s
    passage replaced, under OUT (it includes threefry.cuh from CSRC)."""
    pattern, text = VARIANTS[name]
    src, count = pattern.subn(lambda _: text, (CSRC / "threefry_normal.cu").read_text())
    if count != 1:
        raise SystemExit(f"k7_normal_parent_ab: the {name} variant's passage is found "
                         f"{count} times in csrc/threefry_normal.cu, not once")
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"threefry_normal_{name}.cu"
    path.write_text(src)
    return path


def build_libs(parent: Path):
    """(the older threefry_normal, the older wire_pack, the select variant,
    the 8-block variant) libraries."""
    from repro_torch.kernels import build as B

    src = parent / "src" / "repro_torch" / "kernels" / "csrc"
    libs = []
    for name, path in (("threefry_normal", src / "threefry_normal.cu"),
                       ("wire_pack", src / "wire_pack.cu"),
                       ("threefry_normal_select", variant_source("select")),
                       ("threefry_normal_pairs8", variant_source("pairs8"))):
        lib = OUT / f"{name}.so"
        _nvcc(*B.NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(path))
        libs.append(ctypes.CDLL(str(lib)))
    normal, wire, select, pairs8 = libs
    for lib in (normal, select, pairs8):
        lib.threefry_normal_axpy.restype = _I
        lib.threefry_normal_max_leaves.restype = _I
    wire.nibble_pack.argtypes = [_P, _P, _I, _I, _P]
    wire.nibble_unpack.argtypes = [_P, _P, _I, _I, _P]
    wire.dequantize.argtypes = [_P, _P, _I, _P, _I, _I, _P]
    return normal, wire, select, pairs8


def _sass_counts(cubin: Path) -> dict:
    """{function: {class: instructions}} of a cubin (NOPs left out), with
    "to exit" the instructions before the function's first EXIT: the
    straight path, without the code laid out after it (an IEEE division's
    or root's slow path, a rare branch)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    counts: dict = {}
    fn = None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = {}
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn is None or not ins or ins.group(1) == "NOP":
            continue
        op = ins.group(1)
        if op == "EXIT":
            counts[fn].setdefault("to exit", sum(v for k, v in counts[fn].items()
                                                 if k != "to exit"))
        what = next((c for c, ops in _CLASSES if op in ops or op.lstrip("U") in ops), "other")
        if op.startswith("U") and op.lstrip("U") in {o for _, ops in _CLASSES for o in ops}:
            what = "uniform"
        counts[fn][what] = counts[fn].get(what, 0) + 1
    return counts


def sass(parent: Path) -> None:
    """The SASS counts of both normal kernels and of the probes."""
    from repro_torch.kernels import build as B

    OUT.mkdir(parents=True, exist_ok=True)
    flags = [f for f in B.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    probe = ROOT / "tools" / "normal_sass_probe.cu"
    for tag, csrc in (("older", parent / "src" / "repro_torch" / "kernels" / "csrc"),
                      ("this checkout's", CSRC)):
        for what, src, extra in (
                ("kernel", csrc / "threefry_normal.cu", []),
                ("select variant", None, ["-I", str(CSRC)]),
                ("probes", probe, [f'-DNORMAL_SOURCE="{csrc / "threefry_normal.cu"}"',
                                   "-I", str(csrc)] + (["-DPARENT"] if tag == "older" else []))):
            if what == "select variant":
                if tag == "older":
                    continue
                src = variant_source("select")
            cubin = OUT / f"{'old' if tag == 'older' else 'new'}_{what.replace(' ', '_')}.cubin"
            _nvcc(*flags, "-cubin", *extra, "-o", str(cubin), str(src))
            for fn, by_class in _sass_counts(cubin).items():
                total = sum(v for k, v in by_class.items() if k != "to exit")
                parts = ", ".join(f"{c} {n}" for c, n in sorted(by_class.items()))
                print(f"[k7 parent] SASS {tag} {what} {fn}: {total} instructions ({parts})",
                      flush=True)
    ncu = shutil.which("ncu") or ("/usr/local/cuda/bin/ncu"
                                  if Path("/usr/local/cuda/bin/ncu").exists() else None)
    print(f"[k7 parent] ncu: {ncu or 'not on this machine'}", flush=True)


def old_k7(torch, lib, W, what: str, *args):
    """The older K7 kernels through this checkout's wrappers' preparation."""
    stream = torch.cuda.current_stream().cuda_stream
    if what == "pack":
        (codes,) = args
        K, n = codes.shape
        out = torch.empty((K, (n + 1) // 2), dtype=torch.int8, device=codes.device)
        err = lib.nibble_pack(codes.data_ptr(), out.data_ptr(), K, n, stream)
    elif what == "unpack":
        packed, n = args
        K = packed.shape[0]
        out = torch.empty((K, n), dtype=torch.int8, device=packed.device)
        err = lib.nibble_unpack(packed.data_ptr(), out.data_ptr(), K, n, stream)
    else:
        codes, scale = args
        K, n = codes.shape
        s, stride = W._scale_tensor(scale, K, codes)
        out = torch.empty((K, n), dtype=torch.float32, device=codes.device)
        err = lib.dequantize(codes.data_ptr(), s.data_ptr(), stride, out.data_ptr(), K, n, stream)
    if err:
        raise SystemExit(f"k7_normal_parent_ab: the older {what} launch returned {err}")
    return out


def k7_cases(torch, lib, W, gen, K: int, n: int, sets: int = 1) -> dict:
    """{what: (older, this checkout's)} of K7's kernels on codes from
    ``gen``: each call takes the next of ``sets`` sets of inputs in turn."""
    codes4 = [torch.randint(-8, 8, (K, n), generator=gen, device="cuda", dtype=torch.int8)
              for _ in range(sets)]
    codes8 = [torch.randint(-127, 128, (K, n), generator=gen, device="cuda", dtype=torch.int8)
              for _ in range(sets)]
    packed = [W.nibble_pack(c) for c in codes4]
    per_client = torch.rand(K, generator=gen, device="cuda") * 1e-3 + 1e-5
    shared = per_client[0].clone()

    def turn(fn, inputs, *rest):  # fn on the next set of inputs at each call
        cycle = itertools.cycle(inputs)
        return lambda: fn(next(cycle), *rest)

    return {
        "nibble_pack": (turn(lambda c: old_k7(torch, lib, W, "pack", c), codes4),
                        turn(W.nibble_pack, codes4)),
        "nibble_unpack": (turn(lambda q: old_k7(torch, lib, W, "unpack", q, n), packed),
                          turn(W.nibble_unpack, packed, n)),
        "dequantize per-client scale": (
            turn(lambda c: old_k7(torch, lib, W, "dequantize", c, per_client), codes8),
            turn(W.dequantize, codes8, per_client)),
        "dequantize shared scale": (
            turn(lambda c: old_k7(torch, lib, W, "dequantize", c, shared), codes8),
            turn(W.dequantize, codes8, shared)),
    }


def cold_sets(K: int, n: int) -> int:
    """Sets of inputs whose smallest, the packed bytes, pass 4 L2s."""
    return math.ceil(4 * L2_BYTES / (K * ((n + 1) // 2)))


class _Swap:
    """Runs the normal kernel's wrapper on the older library inside."""

    def __init__(self, KN, lib):
        self.KN, self.lib, self.saved = KN, lib, KN._lib

    def __enter__(self):
        self.KN._lib = lambda: self.lib

    def __exit__(self, *exc):
        self.KN._lib = self.saved


def normal_bits(torch, cs, KN, lib, what: str) -> None:
    """The normal kernel, this checkout's and ``lib``'s, at the paper's
    table, the ragged set and the run edges: equal bits."""
    from repro_torch.core import fvn, keys
    from repro_torch.core.compression import jax_leaf_order

    gen = torch.Generator(device="cuda").manual_seed(11)
    params = cs._paper_task(True).init_params(gen)
    xs = [params[n] for n in jax_leaf_order(list(params))]
    key = fvn.fvn_key(keys.PRNGKey(0), 1, 2, 1)
    tables = [("paper table", xs, keys.split(key, len(xs)), [0.01] * len(xs))]
    for spec, tag in ((cs.NORMAL_RAGGED, "ragged"), (cs.normal_edges(KN), "run edges")):
        rx, rs = cs._normal_case(torch, gen, spec)
        tables.append((tag, rx, keys.split(keys.fold_in(key, len(spec)), len(spec)), rs))
    for tag, txs, tk, ts in tables:
        with _Swap(KN, lib):
            old = KN.normal_axpy(txs, tk, ts)
        new = KN.normal_axpy(txs, tk, ts)
        for x, a, b in zip(txs, old, new):
            cs._bitwise(torch, b, a, f"threefry_normal {tag} {x.numel()} {x.dtype} against "
                        f"{what}")
        cs.log(f"[k7 parent] threefry_normal {tag} ({len(txs)} tensors): equal to {what} bit "
               "for bit")


def paper_calls(torch, cs, KN, *libs):
    """(the first of ``libs``, this checkout's, the others of ``libs``)
    normal kernel calls at the paper's table, as closures."""
    from repro_torch.core import fvn, keys
    from repro_torch.core.compression import jax_leaf_order

    params = cs._paper_task(True).init_params(torch.Generator(device="cuda").manual_seed(0))
    xs = [params[n] for n in jax_leaf_order(list(params))]
    lk = keys.split(fvn.fvn_key(keys.PRNGKey(0), 1, 2, 1), len(xs))

    def call(lib=None):
        if lib is None:
            return KN.normal_axpy(xs, lk, [0.01] * len(xs))
        with _Swap(KN, lib):
            return KN.normal_axpy(xs, lk, [0.01] * len(xs))

    first, *others = libs
    return ((lambda: call(first)), call) + tuple((lambda lib=lib: call(lib)) for lib in others)


def once(torch, cs, KN, *libs) -> None:
    for fn in paper_calls(torch, cs, KN, *libs):
        fn()
    torch.cuda.synchronize()


def turns(torch, cs, line: str, old, new, eager_calls: int, graph_calls: int,
          names: str = "old, new, new, old") -> None:
    eager = [cs.cuda_ms(torch, fn, eager_calls) for fn in (old, new, new, old)]
    graph = [cs.graph_ms(torch, fn, graph_calls) for fn in (old, new, new, old)]
    cs.log(f"[k7 parent] {line}, us a call in the order {names}: eager "
           + ", ".join(f"{t * 1e3:.2f}" for t in eager) + "; graph "
           + ", ".join(f"{t * 1e3:.2f}" for t in graph))


def round_turns(torch, cs, KN, lib) -> None:
    """The K2 round and the slow path's DP and gaussian run with the older
    normal kernel and the new, in turns (old, new, new, old)."""
    from repro_torch.launch import train

    cs._dispatch("auto")
    task = cs._paper_task(True)
    dp_gaussian = next(flags for name, flags, _, _ in cs.SLOWPATH if "gaussian" in name)
    for what, flags, rounds in (("the K2 round", [], 2),
                                ("the slow path's DP and gaussian run", dp_gaussian, 3)):
        for side in ("old", "new", "new", "old"):
            args = train.parse_args(cs.PAPER_ARGV + ["--rounds", str(rounds)] + flags)
            corpus = task.make_corpus(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            watch = cs._RunWatch(torch, f"[k7 parent] {what} {side}", rounds)
            with _Swap(KN, lib if side == "old" else KN._lib()):
                state, hist = train.run_federated(task, corpus, train.build_plan(args), rounds,
                                                  seed=args.seed, device="cuda", eval_every=0,
                                                  eval_examples=0, log=watch)
            del state, corpus  # not held into the next run's peak
            by_name = cs._device_times(torch, watch.prof)
            dev = sum(t for t, _ in by_name.values()) / 1e3
            events = sum(c for _, c in by_name.values())
            normal = sum(t for k, (t, _) in by_name.items() if "threefry_normal" in k) / 1e3
            cs.log(f"[k7 parent] {what}, {side} normal kernel: losses {hist['loss']}; ms per "
                   f"round {[round(x * 1e3, 1) for x in hist['round_s']]} (the last profiled); "
                   f"its device kernel time {dev:.2f} ms in {events} device events, the normal "
                   f"kernel {normal:.3f} ms of it; peak memory "
                   f"{torch.cuda.max_memory_allocated()} B")


def main() -> int:
    args = [a for a in sys.argv[1:] if a not in ("--sass", "--once")]
    if len(args) != 1:
        raise SystemExit(__doc__)
    parent = Path(args[0]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import threefry_normal as KN
    from repro_torch.kernels import wire_pack as W

    if not torch.cuda.is_available():
        raise SystemExit("k7_normal_parent_ab: no CUDA device is available")
    cs.phase_card(torch)
    if "--sass" in sys.argv:
        sass(parent)
        return 0
    normal_lib, wire_lib, select_lib, pairs8_lib = build_libs(parent)
    build.build(("wire_pack", "threefry_normal"))
    if "--once" in sys.argv:  # one call of each normal kernel, for a profiler
        once(torch, cs, KN, normal_lib, select_lib, pairs8_lib)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(5)
    for K, sizes in ((cs.WIRE_CLIENTS, cs.WIRE_SIZES + W.K7_RUN_EDGES + cs.K7_LARGE),
                     (3, W.K7_RUN_EDGES)):
        for n in sizes:
            cases = k7_cases(torch, wire_lib, W, gen, K, n)
            for what, (old, new) in cases.items():
                cs._bitwise(torch, new(), old(), f"K7 {what} K={K} n={n} against the older "
                            "design")
            cs.log(f"[k7 parent] K={K} n={n}: K7's {len(cases)} variants equal the older "
                   "design's bit for bit")
            if n == cs.WIRE_SIZES[0]:
                for what, (old, new) in cases.items():
                    turns(torch, cs, f"{what} K={K} n={n}", old, new, 50, 20)
                del cases
                sets = cold_sets(K, n)
                cases = k7_cases(torch, wire_lib, W, gen, K, n, sets)
                for what, (old, new) in cases.items():
                    turns(torch, cs, f"{what} K={K} n={n}, cold L2 (the inputs in turn from "
                          f"{sets} sets)", old, new, 50, 20)
            del cases
    normal_bits(torch, cs, KN, normal_lib, "the older design")
    normal_bits(torch, cs, KN, select_lib, "the select variant")
    normal_bits(torch, cs, KN, pairs8_lib, "the 8-block variant")
    old_normal, new_normal, select_normal, pairs8_normal = paper_calls(
        torch, cs, KN, normal_lib, select_lib, pairs8_lib)
    table = "threefry_normal at the paper's 35 tensors (105,333,760 fp32)"
    turns(torch, cs, table, old_normal, new_normal, 20, 10)
    turns(torch, cs, f"{table}, this design against its select variant (both log1p branches a "
          "draw)", select_normal, new_normal, 20, 10, "select, new, new, select")
    turns(torch, cs, f"{table}, this design against its 8-block variant (8 threefry blocks a "
          "thread)", pairs8_normal, new_normal, 20, 10, "8 blocks, new, new, 8 blocks")
    del old_normal, new_normal, select_normal, pairs8_normal
    round_turns(torch, cs, KN, normal_lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
