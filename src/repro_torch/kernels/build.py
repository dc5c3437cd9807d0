"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is
compiled by ``nvcc`` for ``sm_90a`` into
``<checkout>/build/repro_torch_kernels/lib<name>-<hash>.so``, where the
hash is that of the sources and of every header under ``csrc/`` (and, for
a library built against torch, of torch's version and C++ ABI flag), so an
edited source or header or another torch never loads a stale library. The library is then opened with ``ctypes``. A library in
``OP_SOURCES`` also links a C++ file that registers PyTorch operators
around the ``.cu``'s entry points; it is compiled against torch's
headers and libraries and loaded with ``torch.ops.load_library``
(``load_ops``). Only sources in the repository are built, and a failed
build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("lstm_gates", "lstm_scan", "rnnt_joint", "wire_pack", "attention",
           "attention_bwd", "attention_bwd_wgmma", "threefry_normal", "wkv6", "ssm_scan")
# libraries whose entry points are PyTorch operators: the C++ file that
# registers them, built beside csrc/<name>.cu
OP_SOURCES = {"lstm_gates": "lstm_gates_op.cpp"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills per kernel, in the build log
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return path


def _sources(name: str) -> list:
    return [CSRC / f"{name}.cu"] + ([CSRC / OP_SOURCES[name]] if name in OP_SOURCES else [])


def _headers() -> list:
    """The headers a source may include (``csrc/*.cuh``): every library's
    name hashes them all."""
    return sorted(CSRC.glob("*.cuh"))


def _torch_flags() -> list:
    """Compile against torch's headers with its C++ ABI, and link to the
    libraries that hold the operator registry and the tensors."""
    root = Path(torch.__file__).resolve().parent
    lib = str(root / "lib")
    return ["-I", str(root / "include"),
            f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            "-L", lib, "-lc10", "-ltorch_cpu", "-Xlinker", "-rpath", "-Xlinker", lib]


def library_path(name: str) -> Path:
    key = b"".join(f.read_bytes() for f in _sources(name) + _headers())
    if name in OP_SOURCES:  # compiled against torch's headers and ABI: bound to this torch
        key += f"torch {torch.__version__} abi {int(torch._C._GLIBCXX_USE_CXX11_ABI)}".encode()
    digest = hashlib.sha256(key).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns {name: build
    log} for the sources compiled by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources(name))]
        if name in OP_SOURCES:
            cmd += _torch_flags()
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc exited {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a reader never opens a half-written library
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def load_ops(name: str) -> None:
    """Build the library of ``csrc/<name>.cu`` and its ``OP_SOURCES``
    file if needed, and register its operators under ``torch.ops``."""
    build((name,))
    torch.ops.load_library(str(library_path(name)))


def check_launch(err: int, what: str) -> None:
    """Raise on the cudaError a library entry point returned (0 is
    success; a negative value is a driver CUresult, negated): a refused
    launch never runs, and nothing else reports it."""
    if err > 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
    if err < 0:
        raise RuntimeError(f"{what} launch failed: CUresult {-err}")


def kernel_info(lib: ctypes.CDLL, entry: str, *widths) -> dict:
    """A built kernel's block on the current card from a library's
    ``*_info`` entry (``entry(*widths, int out[6])``): threads, dynamic
    shared bytes, registers a thread, blocks an SM, local (spilled) bytes a
    thread and blocks a (batch row, head), 0 where the entry leaves it."""
    out = (ctypes.c_int * 6)()
    check_launch(getattr(lib, entry)(*widths, ctypes.addressof(out)), entry)
    return dict(zip(("threads", "shared_bytes", "registers", "blocks_per_sm", "local_bytes",
                     "blocks"), out))
