#!/usr/bin/env python3
"""Time the phases of the step-wise K2 backward recurrence, the design
before the gate recompute was hoisted out of the steps, on one CUDA card,
beside the current design on the same inputs.

    git archive 2e12d11 | tar -x -C build/k2_parent   # any commit with that design
    python3 tools/k2_bwd_parent_phases.py build/k2_parent

The tool takes the older checkout's ``csrc/lstm_scan.cu`` and builds it
twice with this checkout's nvcc flags: as it is, and with a phase clock
written into its backward kernel (thread 0 of each block sums, in
registers, the nanoseconds of %globaltimer since its last mark into the
phase the mark ends, and stores a step's sums when the step ends). At the
paper's encoder layer (S=64, B=4, H=1152, bf16 xg, inputs from a seed) it
prints the card's name and power limit, then: the untimed old kernel's
eager time and this checkout's ``lstm_scan_bwd_rec`` on the same inputs
(CUDA events; old, new, new, old), and the timed old kernel's phases in us
a step (the prologue and epilogue in us a launch), the mean over the
blocks and the slowest block. The old kernel's outputs, timed and untimed,
must equal each other and hold to the plain version.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (64, 4, 1152)  # S, B, H: the paper's encoder layer in a client step of b=4
PHASES = ("prologue", "stage h_prev", "gate recompute", "stage shares", "cell update",
          "share product and stores", "barrier", "epilogue")

# the phase clock, put before the old backward kernel
CLOCK = r"""
// (timed copy) the backward's phase clock: the table is (grid, S + 1, 8)
__device__ unsigned long long* g_phase_times = nullptr;
struct PhaseClock {
  unsigned long long* table;
  unsigned long long last = 0, sums[8] = {};
  __device__ explicit PhaseClock(int S) : table(g_phase_times + blockIdx.x * (S + 1) * 8) {
    last = now();
  }
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ void mark(int phase) {
    if (threadIdx.x == 0) {
      const unsigned long long t = now();
      sums[phase] += t - last;
      last = t;
    }
  }
  // a step's phases (1 .. 6) into row t, restarted
  __device__ void store_step(int t) {
    if (threadIdx.x == 0) {
      for (int i = 1; i < 7; ++i) {
        table[t * 8 + i] = sums[i];
        sums[i] = 0;
      }
    }
  }
  // the prologue and the epilogue into row S
  __device__ void store_launch(int S) {
    if (threadIdx.x == 0) {
      table[S * 8] = sums[0];
      table[S * 8 + 7] = sums[7];
    }
  }
};

"""

# (anchor in the old source, its replacement): each anchor must occur once
EDITS = (
    ("template <typename T, int BB>\n__global__ void __launch_bounds__(kThreads)\n"
     "    lstm_scan_bwd_kernel(",
     CLOCK + "template <typename T, int BB>\n__global__ void __launch_bounds__(kThreads)\n"
     "    lstm_scan_bwd_kernel("),
    ("  float* dc_s = dg_s + p.Bp * ncol;      // (B, U) the dc carry of the block's units\n",
     "  float* dc_s = dg_s + p.Bp * ncol;      // (B, U) the dc carry of the block's units\n"
     "  PhaseClock clk(p.S);\n"),
    ("idx < p.Bp * ncol; idx += blockDim.x) dg_s[idx] = 0.0f;\n\n"
     "  for (int t = p.S - 1; t >= 0; --t) {\n",
     "idx < p.Bp * ncol; idx += blockDim.x) dg_s[idx] = 0.0f;\n  clk.mark(0);\n\n"
     "  for (int t = p.S - 1; t >= 0; --t) {\n"),
    ("        stage_rows<BB>(h_s, ys + (t - 1) * BH, b0, p, false);\n      }\n"
     "      __syncthreads();\n      gate_dots<BB>(w_s, h_s, red, p);\n      __syncthreads();\n",
     "        stage_rows<BB>(h_s, ys + (t - 1) * BH, b0, p, false);\n      }\n"
     "      __syncthreads();\n      clk.mark(1);\n      gate_dots<BB>(w_s, h_s, red, p);\n"
     "      __syncthreads();\n      clk.mark(2);\n"),
    ("        stage_shares<BB>(h_s, shares_in, b0, p, nblk, j0);\n        __syncthreads();\n"
     "      }\n",
     "        stage_shares<BB>(h_s, shares_in, b0, p, nblk, j0);\n        __syncthreads();\n"
     "      }\n      clk.mark(3);\n"),
    ("        dc_s[b * U + u] = dc * f;\n      }\n    }\n    __syncthreads();\n",
     "        dc_s[b * U + u] = dc * f;\n      }\n    }\n    __syncthreads();\n"
     "    clk.mark(4);\n"),
    ("    grid.sync();  // every block's share of dh_prev is published\n",
     "    clk.mark(5);\n    grid.sync();  // every block's share of dh_prev is published\n"
     "    clk.mark(6);\n    clk.store_step(t);\n"),
    ("      dc0[bj] = dc_s[(b0 + r) * U + u];\n    }\n  }\n}\n",
     "      dc0[bj] = dc_s[(b0 + r) * U + u];\n    }\n  }\n  clk.mark(7);\n"
     "  clk.store_launch(p.S);\n}\n"),
)

SET_TIMES = r"""
extern "C" int set_phase_times(void* table) {
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_times, &table, sizeof(table)));
}
"""


def timed_source(src: str) -> str:
    for anchor, new in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"k2_bwd_parent_phases: the old source does not hold this anchor "
                             f"once (not the step-wise design?):\n{anchor}")
        src = src.replace(anchor, new)
    return src + SET_TIMES


def build(parent: Path) -> tuple:
    """(untimed library, timed library) of the old source."""
    from repro_torch.kernels import build as B

    src = (parent / "src" / "repro_torch" / "kernels" / "csrc" / "lstm_scan.cu").read_text()
    out = ROOT / "build" / "k2_parent_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "untimed.cu").write_text(src)
    (out / "timed.cu").write_text(timed_source(src))
    procs = [subprocess.Popen([B._nvcc(), *B.NVCC_FLAGS, "-o", str(out / f"{n}.so"),
                               str(out / f"{n}.cu")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for n in ("untimed", "timed")]
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k2_bwd_parent_phases: nvcc exited {proc.returncode}\n{log}")
    libs = []
    for n in ("untimed", "timed"):
        lib = ctypes.CDLL(str(out / f"{n}.so"))
        lib.lstm_scan_bwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 13 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.lstm_scan_bwd.restype = ctypes.c_int
        libs.append(lib)
    libs[1].set_phase_times.argtypes = [ctypes.c_void_p]
    return tuple(libs)


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import lstm_scan as K
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        raise SystemExit("k2_bwd_parent_phases: no CUDA device is available")
    cs.phase_card(torch)
    untimed, timed = build(parent)
    S, B, H = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    xg, w = rnd(S, B, 4 * H, scale=0.5).bfloat16(), rnd(H, 4 * H, scale=H ** -0.5)
    h0, c0 = rnd(B, H, scale=0.1), rnd(B, H, scale=0.1)
    ys, cs_ = K.lstm_scan_fwd(xg, w, h0, c0)
    args = (xg, w, h0, c0, ys, cs_, rnd(S, B, H).bfloat16(), rnd(B, H).bfloat16(), rnd(B, H))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    U = -(-H // sms)
    nblk = -(-H // U)
    stream = torch.cuda.current_stream().cuda_stream

    def old(lib):
        dxg = torch.empty((S, B, 4 * H), device="cuda")
        dh0, dc0 = torch.empty((B, H), device="cuda"), torch.empty((B, H), device="cuda")
        pbuf = torch.empty((2, nblk, B, H), device="cuda")
        err = lib.lstm_scan_bwd(1, *(a.data_ptr() for a in args), dxg.data_ptr(),
                                dh0.data_ptr(), dc0.data_ptr(), pbuf.data_ptr(), S, B, H, U,
                                stream)
        if err:
            raise SystemExit(f"k2_bwd_parent_phases: the old backward's launch returned {err}")
        return dxg, dh0, dc0

    times = torch.zeros((nblk, S + 1, len(PHASES)), dtype=torch.int64, device="cuda")
    if timed.set_phase_times(times.data_ptr()):
        raise SystemExit("k2_bwd_parent_phases: the phase table could not be set")
    want = old(untimed)
    got = old(timed)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the timed copy's bits differ from the old kernel's")
    rel = cs._rel_err(want, ref.lstm_scan_bwd_rec_ref(*args))
    if rel > cs.SCAN_BWD_REL_TOL:
        raise AssertionError(f"the old backward: error relative to max {rel:.2e}")
    tag = f"S={S} B={B} H={H} bf16"
    ms = {}
    for what, fn in (("old", lambda: old(untimed)), ("new", lambda: K.lstm_scan_bwd_rec(*args)),
                     ("new again", lambda: K.lstm_scan_bwd_rec(*args)),
                     ("old again", lambda: old(untimed))):
        ms[what] = cs.cuda_ms(torch, fn, 20)
    cs.log(f"[k2 parent] backward recurrence {tag}, |err|/max {rel:.2e}; us per call eager: "
           + ", ".join(f"{w} {v * 1e3:.1f}" for w, v in ms.items()))
    old(timed)  # the table of one launch
    torch.cuda.synchronize()
    us = times.double() / 1e3
    per_step = us[:, :S].sum(dim=1) / S
    parts = []
    for i, phase in enumerate(PHASES):
        once = phase in ("prologue", "epilogue")
        col = us[:, S, i] if once else per_step[:, i]
        parts.append(f"{phase} {float(col.mean()):.3f} (slowest block {float(col.max()):.3f}) "
                     + ("us a launch" if once else "us a step"))
    steps = per_step[:, 1:7].sum(dim=1)
    cs.log(f"[k2 parent] timed old backward {tag} ({nblk} blocks, thread 0's %globaltimer): "
           + "; ".join(parts) + f"; all steps' phases {float(steps.mean()):.3f} (slowest block "
           f"{float(steps.max()):.3f}) us a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
