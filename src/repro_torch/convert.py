"""Parameters between the JAX package's tree layout and the port's dicts.

The JAX model keeps its parameters as nested dicts and lists of arrays
(``repro/models/rnnt.py:52``, ``repro/models/lstm.py:141``). The port
keeps one flat dict keyed by the dotted path, which is the name
``nn.Module.named_parameters`` gives (``encoder.0.w_ih``). Both use the
same layout, so the arrays pass unchanged. That holds for the enc-dec
too: its layers stay stacked as in the reference (``enc_layers.attn.wq``
is (L, M, H·D), ``repro/models/encdec.py:100-111``), and the port's
``models/encdec.py`` indexes layer l of each stacked tensor.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu") -> dict:
    """Nested dicts/lists of numpy arrays -> {dotted name: tensor}."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix] = torch.from_numpy(np.array(node)).to(device)
            return
        for key, child in items:
            walk(child, f"{prefix}.{key}" if prefix else str(key))

    walk(tree, "")
    return out


def params_to_jax(params: dict):
    """{dotted name: tensor} -> nested dicts/lists of numpy arrays; a
    path component of digits is a list index."""
    root: dict = {}
    for name, t in params.items():
        node = root
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)
