#!/usr/bin/env python3
"""Hold K10, its backward and K11 at the widths an older checkout takes
against that checkout's kernels on one CUDA card: the same bits, and the
times in turns.

    git archive 442c3bd | tar -x -C build/k10_parent   # K10 at D <= 192, Dv <= 128
    python3 tools/k10_k11_parent_ab.py build/k10_parent

The tool builds the older checkout's ``csrc/attention.cu``,
``csrc/attention_bwd.cu`` and ``csrc/attention_bwd_wgmma.cu`` with this
checkout's nvcc flags, and this checkout's. Their C entries keep one
interface, so both are called with the same arguments: at every row of
``chip_smoke.py``'s K10_SHAPES, K10_BWD_SHAPES and K11_SHAPES (with K11's
split edges) whose widths the older kernels take, in bf16 and fp32, on
inputs drawn as phase 3 draws them, the forward's o and log-sum-exp on the
route ``route`` picks, the backward's dq, dk and dv on ``bwd_route``'s (and,
in bf16, on the CUDA-core design as well), and K11's output must be the
older kernels' bits. Then the card's name and power limit, and at the rows
of TIMED each call's µs in the order old, new, new, old, eager (CUDA events
around back-to-back calls) and from a CUDA graph.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("attention", "attention_bwd", "attention_bwd_wgmma")
# the rows timed in turns: one of each layout the earlier paths train and serve
TIMED = ("encoder", "qwen3-8b heads", "deepseek-v2-lite heads", "llava-next window",
         "train encoder", "cross", "qwen3-8b heads pos 127", "llava-next serve pos 735")


def build_parent(parent: Path) -> dict:
    """{source: the older library}, its entries typed as the port's wrappers type them."""
    from repro_torch.kernels import build as B

    out = ROOT / "build" / "k10_k11_parent"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    procs = {name: subprocess.Popen([B._nvcc(), *B.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
                                     str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in SOURCES}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k10_k11_parent_ab: nvcc exited {proc.returncode} on the older "
                             f"{name}.cu\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    new = {"attention": "_lib", "attention_bwd": "_bwd_lib",
           "attention_bwd_wgmma": "_bwd_wgmma_lib"}
    from repro_torch.kernels import flash_attention as KA

    for name, lib in libs.items():  # the argtypes of this checkout's loader
        mine = getattr(KA, new[name])()
        for entry in ("flash_attention_fwd", "flash_attention_wgmma_fwd", "flash_decode_fwd",
                      "flash_attention_bwd", "flash_attention_bwd_wgmma"):
            if hasattr(mine, entry) and hasattr(lib, entry):
                getattr(lib, entry).argtypes = getattr(mine, entry).argtypes
                getattr(lib, entry).restype = ctypes.c_int
    return libs


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KA

    cs.phase_card(torch)
    old = build_parent(parent)
    new = {"attention": KA._lib(), "attention_bwd": KA._bwd_lib(),
           "attention_bwd_wgmma": KA._bwd_wgmma_lib()}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    flags = lambda kw: (int(bool(kw["causal"])), int(kw["window"] or 0),  # noqa: E731
                        float(kw["logit_softcap"]), int(kw["q_offset"]))
    same_all = True

    def turns(tag, calls: dict, n: int) -> None:
        times = [(w, cs.cuda_ms(torch, calls[w], n), cs.graph_ms(torch, calls[w], max(2, n // 2)))
                 for w in ("old", "new", "new", "old")]
        cs.log(f"[k10 parent] {tag}: us a call in turns, eager / graph: "
               + ", ".join(f"{w} {e * 1e3:.2f} / {g * 1e3:.2f}" for w, e, g in times))

    def report(tag, pairs) -> None:
        nonlocal same_all
        same = [torch.equal(a, b) for a, b in pairs]
        same_all &= all(same)
        cs.log(f"[k10 parent] {tag}: the older kernels' bits: {same}")

    gen = torch.Generator(device="cuda").manual_seed(16)
    for name, B, Sq, Sk, H, Kv, D, Dv, causal, window, cap, off, scale in cs.K10_SHAPES:
        for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype) for s in
                       ((B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, Dv)))
            if D > 192 or Dv > 128:  # past the older kernels' widths
                continue
            kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=off, scale=scale)
            sc = D ** -0.5 if scale is None else float(scale)
            route = KA.route(q, k, v)

            def fwd(lib, q=q, k=k, v=v, kw=kw, sc=sc, route=route, dtype=dtype):
                o = torch.empty((B, Sq, H, Dv), dtype=dtype, device="cuda")
                lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                        B, Sq, Sk, H, Kv, D, Dv, sc, *flags(kw), stream())
                if route == "wgmma":
                    err = lib.flash_attention_wgmma_fwd(*args)
                else:
                    err = lib.flash_attention_fwd(KA.DTYPE_CODES[dtype], *args)
                build.check_launch(err, f"{route} forward")
                return o, lse

            got = {w: fwd(lib["attention"]) for w, lib in (("old", old), ("new", new))}
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            atol, rtol = cs.ATTN_TOL[dname]
            torch.testing.assert_close(got["new"][0].float(), want.float(), atol=atol, rtol=rtol)
            tag = f"flash_attention {name} {dname} ({route})"
            report(tag, zip(got["old"], got["new"]))
            if name in TIMED:
                turns(tag, {w: (lambda lib=lib: fwd(lib["attention"]))
                            for w, lib in (("old", old), ("new", new))},
                      10 if Sq * Sk > 100_000 else 100)

    gen = torch.Generator(device="cuda").manual_seed(26)
    for name, B, Sq, Sk, H, Kv, D, Dv, causal, window, cap, off, scale in cs.K10_BWD_SHAPES:
        for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(dtype) for sh in
                       ((B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, Dv)))
            do = torch.randn((B, Sq, H, Dv), generator=gen, device="cuda").to(dtype)
            if D > 192 or Dv > 128:  # past the older kernels' widths
                continue
            kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=off, scale=scale)
            sc = D ** -0.5 if scale is None else float(scale)
            o, lse = KA.flash_attention_fwd_lse(q, k, v, **kw)
            routes = [KA.bwd_route(q, k, v, o, do)] + (["simt"] if dtype == torch.bfloat16 else [])
            for route in routes:
                def bwd(lib, q=q, k=k, v=v, o=o, lse=lse, do=do, kw=kw, sc=sc, route=route,
                        dtype=dtype):
                    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
                    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr())
                    args = (B, Sq, Sk, H, Kv, D, Dv, sc, *flags(kw), stream())
                    if route == "wgmma":
                        scratch = torch.empty(2 * B * H * -(-Sq // 64) * 64,
                                              dtype=torch.float32, device="cuda")
                        err = lib["attention_bwd_wgmma"].flash_attention_bwd_wgmma(
                            *ptrs, scratch.data_ptr(), *args)
                    else:
                        di = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
                        err = lib["attention_bwd"].flash_attention_bwd(
                            KA.DTYPE_CODES[dtype], *ptrs, di.data_ptr(), *args)
                    build.check_launch(err, f"{route} backward")
                    return dq, dk, dv

                got = {w: bwd(lib) for w, lib in (("old", old), ("new", new))}
                torch.cuda.synchronize()
                tag = f"flash_attention_bwd {name} {dname} ({route})"
                report(tag, zip(got["old"], got["new"]))
                if name in TIMED and route == routes[0]:
                    turns(tag, {w: (lambda lib=lib: bwd(lib))
                                for w, lib in (("old", old), ("new", new))},
                          10 if Sq * Sk > 100_000 else 50)

    gen = torch.Generator(device="cuda").manual_seed(16)
    S_self = cs.K11_SHAPES[0][2]
    edges = tuple(("self pos %d" % p, 4, S_self, 8, 8, 64, p, None, False, 0.0)
                  for p in (KD.SPLIT_SLOTS - 1, KD.SPLIT_SLOTS))
    for name, B, S, H, Kv, D, pos, window, ring, cap in cs.K11_SHAPES + edges:
        if D > 128:
            continue
        for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, kc, vc = (torch.randn(s, generator=gen, device="cuda").to(dtype) for s in
                         ((B, H, D), (B, S, Kv, D), (B, S, Kv, D)))
            pos_t = torch.full((), pos, dtype=torch.int32, device="cuda")

            def dec(lib, q=q, kc=kc, vc=vc, pos_t=pos_t, window=window, ring=ring, cap=cap,
                    dtype=dtype, B=B, S=S, H=H, Kv=Kv, D=D):
                o = torch.empty((B, H, D), dtype=dtype, device="cuda")
                part = torch.empty((B * H * KD.n_splits(S) * (D + 2),), dtype=torch.float32,
                                   device="cuda")
                tickets = torch.zeros((B * Kv,), dtype=torch.int32, device="cuda")
                build.check_launch(lib.flash_decode_fwd(
                    KA.DTYPE_CODES[dtype], q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    o.data_ptr(), pos_t.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, S,
                    Kv, H // Kv, D, D, D ** -0.5, int(window or 0), int(bool(ring)), float(cap),
                    KD.SPLIT_SLOTS, stream()), "flash_decode")
                return o

            got = {w: dec(lib["attention"]) for w, lib in (("old", old), ("new", new))}
            torch.cuda.synchronize()
            tag = f"flash_decode {name} {dname}"
            report(tag, [(got["old"], got["new"])])
            if name in TIMED and dtype == torch.bfloat16:
                turns(tag, {w: (lambda lib=lib: dec(lib["attention"]))
                            for w, lib in (("old", old), ("new", new))}, 200)
    cs.log(f"[k10 parent] every row at the older widths gives the older kernels' bits: "
           f"{same_all}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
