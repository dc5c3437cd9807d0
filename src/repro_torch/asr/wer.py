"""Word-error-rate metric (host-side numpy) for the synthetic corpus.

The port's own copy of ``repro/asr/wer.py:7-34``.
"""
from __future__ import annotations

import numpy as np


def levenshtein(ref, hyp) -> int:
    """Edit distance between two token sequences."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = np.arange(n + 1)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return int(prev[n])


def wer(refs, hyps) -> float:
    """Corpus-level WER: sum(edits) / sum(ref lengths)."""
    edits = 0
    total = 0
    for r, h in zip(refs, hyps):
        r = [t for t in r if t != 0]
        h = [t for t in h if t != 0]
        edits += levenshtein(r, h)
        total += max(len(r), 1)
    return edits / max(total, 1)
