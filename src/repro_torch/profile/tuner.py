"""The tuning registry: dispatch knobs with per-device measured overrides.

The port's counterpart of ``repro/profile/tuner.py``, cut down to the
knobs of the LSTM layer's dispatch (``repro_torch.models.lstm``). Every
knob has a documented default; call sites read it through
:func:`get_knob`, and overrides measured on one device persist to
``results/tuning_torch.json`` (or ``$REPRO_TORCH_TUNING_JSON``), keyed by
that device, so one file serves several machines. The file has the JAX
package's schema (``schema_version``, ``devices`` keyed by device key,
each with its ``fingerprint`` and ``overrides``); the JAX package's own
file is another one.

CLI::

    PYTHONPATH=src python -m repro_torch.profile.tuner --show
    PYTHONPATH=src python -m repro_torch.profile.tuner --set lstm.scan_dispatch ref
    PYTHONPATH=src python -m repro_torch.profile.tuner --autotune lstm           # on the card
    PYTHONPATH=src python -m repro_torch.profile.tuner --autotune lstm --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Callable, Optional

TUNING_SCHEMA_VERSION = 1
DEFAULT_PATH = str(Path(__file__).resolve().parents[3] / "results" / "tuning_torch.json")
ENV_PATH = "REPRO_TORCH_TUNING_JSON"


@dataclasses.dataclass(frozen=True)
class Knob:
    default: object
    doc: str
    choices: Optional[tuple] = None


KNOBS: dict[str, Knob] = {
    "lstm.scan_dispatch": Knob(
        "auto",
        "Backend choice for the full-sequence LSTM scan kernel (K2): 'auto' "
        "takes the kernel for tensors on the card when the shape is eligible, "
        "the per-step time loop otherwise; 'ref' forces the time loop; "
        "'kernel' forces the kernel (its plain version for tensors on the "
        "CPU, as the JAX package's 'pallas' runs interpret mode there).",
        choices=("auto", "kernel", "ref"),
    ),
    "lstm.scan_min_seq": Knob(
        16,
        "Sequence length at or above which the LSTM layer dispatches the "
        "scan kernel; below it the time loop runs (re-measure with "
        "--autotune lstm).",
    ),
    "lstm.scan_max_smem_mb": Knob(
        21.0,
        "Budget (MiB) for the scan kernel's fp32 w_hh (16*H*H bytes). The "
        "H100 kernel spreads it over the shared memory of its blocks, one "
        "block per SM, each holding the four gate columns of its hidden "
        "units for the whole sequence: 132 SMs x 227 KB is 29.3 MiB, less "
        "the h staging. Layers whose weight exceeds it run the time loop. "
        "21 admits the paper's H=1152 (20.25 MiB); the JAX package's "
        "lstm.scan_max_vmem_mb (8) was the TPU's VMEM.",
    ),
}


def _coerce(name: str, value):
    knob = KNOBS[name]
    if knob.choices is not None:
        if value not in knob.choices:
            raise ValueError(f"{name}: {value!r} not in {knob.choices}")
        return value
    out = type(knob.default)(value)
    if out <= 0:
        raise ValueError(f"{name}: must be positive, got {out}")
    return out


def device_fingerprint() -> dict:
    """What makes timings from this process comparable: the card (name
    and compute capability) or the CPU, and the torch and CUDA versions."""
    import platform

    import torch

    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        return {"backend": "cuda", "device_kind": torch.cuda.get_device_name(0),
                "capability": f"sm{major}{minor}", "device_count": torch.cuda.device_count(),
                "torch_version": torch.__version__, "cuda_version": torch.version.cuda}
    return {"backend": "cpu", "device_kind": "cpu", "host_arch": platform.machine(),
            "torch_version": torch.__version__}


def device_key(fp: Optional[dict] = None) -> str:
    """Stable slug of the fingerprint: ``cuda_nvidia_h100_80gb_hbm3_sm90``
    for a card, ``cpu`` without one."""
    fp = fp or device_fingerprint()
    if fp["backend"] == "cpu":
        return "cpu"
    raw = f"cuda_{fp['device_kind']}_{fp['capability']}"
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in raw.lower())


class TuningRegistry:
    """The tuning file's facade: knob overrides keyed by device key."""

    def __init__(self, path: Optional[str] = None, device_key: Optional[str] = None):
        self.path = path or os.environ.get(ENV_PATH, DEFAULT_PATH)
        self._device_key = device_key
        self._doc = self._load()

    def _load(self) -> dict:
        doc = {"schema_version": TUNING_SCHEMA_VERSION, "devices": {}}
        try:
            with open(self.path) as f:
                on_disk = json.load(f)
            if on_disk.get("schema_version") == TUNING_SCHEMA_VERSION:
                doc = on_disk
                doc.setdefault("devices", {})
        except (OSError, json.JSONDecodeError, AttributeError):
            pass  # no file, or a corrupt one: the defaults are always safe
        return doc

    @property
    def device_key(self) -> str:
        if self._device_key is None:
            self._device_key = device_key()
        return self._device_key

    def _device_entry(self, create: bool = False) -> dict:
        devices = self._doc["devices"]
        if create and self.device_key not in devices:
            fp = device_fingerprint() if self.device_key == device_key() else {}
            devices[self.device_key] = {"fingerprint": fp, "overrides": {}}
        return devices.get(self.device_key, {})

    def save(self) -> str:
        self._doc["updated_unix"] = time.time()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._doc, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        return self.path

    def get(self, name: str):
        if name not in KNOBS:
            raise KeyError(f"unknown tuning knob {name!r}; known: {sorted(KNOBS)}")
        overrides = self._device_entry().get("overrides", {})
        return _coerce(name, overrides[name]) if name in overrides else KNOBS[name].default

    def overrides(self) -> dict:
        return dict(self._device_entry().get("overrides", {}))

    def set_override(self, name: str, value, persist: bool = False):
        if name not in KNOBS:
            raise KeyError(f"unknown tuning knob {name!r}; known: {sorted(KNOBS)}")
        value = _coerce(name, value)
        self._device_entry(create=True)["overrides"][name] = value
        if persist:
            self.save()
        return value

    def clear_override(self, name: str, persist: bool = False):
        self._device_entry().get("overrides", {}).pop(name, None)
        if persist:
            self.save()


_ACTIVE: Optional[TuningRegistry] = None


def registry() -> TuningRegistry:
    """The process-wide registry (created at first use from
    ``$REPRO_TORCH_TUNING_JSON`` or ``results/tuning_torch.json``)."""
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = TuningRegistry()
    return _ACTIVE


def set_registry(reg: Optional[TuningRegistry]) -> None:
    """Install (or, with None, reset) the process-wide registry."""
    global _ACTIVE
    _ACTIVE = reg


def get_knob(name: str):
    """The knob's override for this device, else its default."""
    return registry().get(name)


def _time_min(fns: dict, reps: int, sync) -> dict:
    """Least seconds per call of each function over ``reps`` rounds that
    visit the functions in rotating order, after one warm-up call each."""
    names = list(fns)
    for name in names:
        fns[name]()
    sync()
    best = {name: float("inf") for name in names}
    for r in range(reps):
        for name in names[r % len(names):] + names[:r % len(names)]:
            t0 = time.perf_counter()
            fns[name]()
            sync()
            best[name] = min(best[name], time.perf_counter() - t0)
    return best


def autotune_lstm_scan(
    reg: Optional[TuningRegistry] = None,
    seq_lens=(4, 8, 16, 32, 64, 128),
    batch: int = 8,
    hidden: int = 128,
    reps: int = 5,
    persist: bool = True,
    device: str = "cuda",
    log=print,
) -> int:
    """Time the scan kernel (K2) against the time loop (K1 per step),
    forward plus backward of one layer's recurrence, over ``seq_lens``,
    and set ``lstm.scan_min_seq`` to the first length where the kernel
    wins (twice the longest if it never does).

    On the CPU both run their plain versions, so the crossover checks the
    machinery and not the card's dispatch. The measurement belongs to the
    registry's device: a ``device`` of another kind raises."""
    import torch

    from repro_torch.kernels.lstm_gates import lstm_gates
    from repro_torch.kernels.lstm_scan import lstm_scan_fused_vjp

    reg = reg or registry()
    dev = torch.device(device)
    if (reg.device_key == "cpu") != (dev.type == "cpu"):
        raise ValueError(f"the registry's device is {reg.device_key}; "
                         f"a measurement on {dev} cannot tune it")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = (torch.randn((hidden, 4 * hidden), generator=gen, device=dev) * 0.1).requires_grad_()
    h0 = torch.zeros((batch, hidden), device=dev)
    c0 = torch.zeros((batch, hidden), device=dev)
    crossover = None
    for S in seq_lens:
        xg = torch.randn((S, batch, 4 * hidden), generator=gen, device=dev).requires_grad_()

        def loop():
            h, c, ys = h0, c0, []
            for t in range(S):
                h, c = lstm_gates(xg[t] + h @ w, c)
                ys.append(h)
            (torch.stack(ys) ** 2).sum().backward()

        def kernel():
            ys, _, _ = lstm_scan_fused_vjp(xg, w, h0, c0)
            (ys ** 2).sum().backward()

        t = _time_min({"loop": loop, "kernel": kernel}, reps, sync)
        log(f"[tuner] lstm_scan S={S} B={batch} H={hidden} on {dev}: time loop "
            f"{t['loop'] * 1e6:.1f} us, kernel {t['kernel'] * 1e6:.1f} us")
        if crossover is None and t["kernel"] < t["loop"]:
            crossover = S
    chosen = crossover if crossover is not None else max(seq_lens) * 2
    reg.set_override("lstm.scan_min_seq", chosen, persist=persist)
    log(f"[tuner] lstm.scan_min_seq <- {chosen} (device {reg.device_key})")
    return chosen


AUTOTUNERS: dict[str, Callable] = {"lstm": autotune_lstm_scan}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", default=None, help=f"tuning JSON (default {DEFAULT_PATH})")
    ap.add_argument("--show", action="store_true", help="print knobs + overrides for this device")
    ap.add_argument("--set", nargs=2, metavar=("NAME", "VALUE"), action="append", default=[])
    ap.add_argument("--autotune", choices=sorted(AUTOTUNERS), action="append", default=[])
    ap.add_argument("--device", default="cuda",
                    help="where --autotune measures (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    reg = TuningRegistry(path=args.path)
    for name, value in args.set:
        reg.set_override(name, value, persist=True)
        print(f"{name} <- {reg.get(name)!r}")
    for target in args.autotune:
        AUTOTUNERS[target](reg, device=args.device)
    if args.show or not (args.set or args.autotune):
        overrides = reg.overrides()
        print(f"# device {reg.device_key} ({reg.path})")
        for name in sorted(KNOBS):
            src = "override" if name in overrides else "default"
            print(f"{name:24s} = {reg.get(name)!r:10} [{src}] {KNOBS[name].doc.split('.')[0]}")


if __name__ == "__main__":
    main()
