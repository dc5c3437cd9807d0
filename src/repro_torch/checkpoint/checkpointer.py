"""npz checkpoints of a parameter dict, with the round they belong to.

The port of ``repro/checkpoint/checkpointer.py``, in its file format, so
that a checkpoint written by either package loads in the other:

- ``<base>.npz`` holds ``leaf_i``, the i-th tensor in the order
  ``jax.tree_util`` flattens the reference's nested tree
  (``core/compression.py:jax_leaf_order``);
- ``<base>.json`` holds ``paths`` (``encoder/0/w_ih``: the dotted name
  with ``/``, as the reference's ``_path_str`` gives it) and ``extra``.

numpy has no bfloat16, so a bf16 tensor is refused rather than written in
a form the reference cannot read (the paper-width RNN-T is fp32).
``Checkpointer`` keeps the last ``keep`` rounds as
``<dir>/ckpt_<round>.{npz,json}``.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.core.compression import jax_leaf_order


def _path_str(name: str) -> str:
    return name.replace(".", "/")


def save_pytree(path: str, params: dict, extra: dict | None = None) -> None:
    names = jax_leaf_order(params)
    arrays = {}
    for i, name in enumerate(names):
        t = params[name]
        if isinstance(t, torch.Tensor):
            if t.dtype == torch.bfloat16:
                raise ValueError(
                    f"checkpoint: {name} is bfloat16, which numpy cannot hold, so neither "
                    "can the npz file the reference reads; cast the tree to float32 first")
            t = t.detach().cpu().numpy()
        arrays[f"leaf_{i}"] = np.asarray(t)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"paths": [_path_str(n) for n in names], "extra": extra or {}}, f)


def load_pytree(path: str, like: dict) -> tuple[dict, dict]:
    """(params in ``like``'s names, dtypes and devices, the manifest's
    extra)."""
    with np.load(path + ".npz") as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    with open(path + ".json") as f:
        manifest = json.load(f)
    names = jax_leaf_order(like)
    if len(leaves) != len(names):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, reference tree has "
                         f"{len(names)}")
    if manifest["paths"] != [_path_str(n) for n in names]:
        raise ValueError(f"checkpoint paths {manifest['paths']} are not the tree's")
    out = {name: torch.from_numpy(leaf).to(device=like[name].device, dtype=like[name].dtype)
           for name, leaf in zip(names, leaves)}
    return {name: out[name] for name in like}, manifest["extra"]


class Checkpointer:
    """Rolling round-indexed checkpoints: ``<dir>/ckpt_<round>.{npz,json}``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _rounds(self) -> list:
        rounds = (re.match(r"ckpt_(\d+)\.json$", f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in rounds if m)

    def save(self, round_idx: int, params: dict, extra: dict | None = None) -> str:
        base = os.path.join(self.directory, f"ckpt_{round_idx}")
        save_pytree(base, params, {"round": round_idx, **(extra or {})})
        for r in self._rounds()[: -self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.directory, f"ckpt_{r}{ext}"))
                except FileNotFoundError:
                    pass
        return base

    def latest_round(self) -> int | None:
        rounds = self._rounds()
        return rounds[-1] if rounds else None

    def restore_latest(self, like: dict):
        """(params, extra) of the latest round, or None if there is none."""
        r = self.latest_round()
        if r is None:
            return None
        return load_pytree(os.path.join(self.directory, f"ckpt_{r}"), like)
