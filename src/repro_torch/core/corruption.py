"""Adversarial client corruption: the Byzantine side of the frontier.

The port of ``repro/core/corruption.py``. An adversary transforms what
the server receives, the clients' post-compression deltas
({name: (K, ...)}), for the clients of a per-round Bernoulli(rate) draw:

- ``sign_flip``: a corrupted client reports ``-scale * delta``;
- ``gaussian``: it adds white noise at ``scale`` times each leaf's RMS of
  its delta;
- ``zero``: it reports an all-zero delta (still claiming its examples);
- ``stale``: it replays ``scale`` times its last honest (post-
  compression) delta from the server state's cache (``ServerState.stale``,
  zeros before its first report). The cache stores the honest stream of
  every participant, corrupted ones too, so a replay is one round old.

``label_shuffle`` is a data-plane adversary: the sampler permutes the
selected clients' transcripts host-side (``data/synthetic.py``,
``FederatedSampler(label_shuffle_rate=...)``), and in the round it is the
identity; the driver reports its counts from the sampler.

The corrupted-client mask is multiplied by the participation mask: a
dropped client is never a corrupted contributor. Corruption changes no
wire bytes: a corrupted participant still uploads a full payload. The
draws are the reference's threefry draws (``core/keys.py``), bit for bit:
the mask, and the gaussian noise (one normal kernel launch a call on the
card, ``kernels/threefry_normal.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import keys as keys_lib
from repro_torch.core.compression import jax_leaf_order
from repro_torch.kernels import threefry_normal

# the in-round delta corruptions and the data-plane kind
DELTA_KINDS = ("sign_flip", "gaussian", "zero", "stale")
KINDS = ("none",) + DELTA_KINDS + ("label_shuffle",)

Corruption = Callable[..., dict]

_CORRUPTIONS: Dict[str, Corruption] = {}


def register_corruption(name: str):
    def deco(fn: Corruption) -> Corruption:
        _CORRUPTIONS[name] = fn
        return fn

    return deco


def get_corruption(name: str) -> Corruption:
    try:
        return _CORRUPTIONS[name]
    except KeyError:
        raise KeyError(f"unknown corruption {name!r}; "
                       f"available: {sorted(_CORRUPTIONS)}") from None


def available_corruptions() -> list[str]:
    return sorted(_CORRUPTIONS)


@dataclasses.dataclass(frozen=True)
class CorruptionConfig:
    """The adversary of a plan: its kind, the probability that a
    participating client is corrupted in a round, and its magnitude."""
    kind: str = "none"      # see KINDS
    rate: float = 0.0       # P(participating client is corrupted), per round
    scale: float = 1.0      # magnitude knob (sign_flip/gaussian/stale)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown corruption kind {self.kind!r}; available: {KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"corruption rate must be in [0, 1], got {self.rate}")


# ----------------------------------------------------------------------
# Registry entries: fn(deltas, key, scale, stale) -> corrupted deltas of
# every client; make_corruption_fn selects them per client.
# ----------------------------------------------------------------------

@register_corruption("sign_flip")
def sign_flip(deltas: dict, key, scale: float, stale) -> dict:
    """-scale * delta (gradient ascent at scale >= 1)."""
    return {n: -scale * d.float() for n, d in deltas.items()}


@register_corruption("gaussian")
def gaussian(deltas: dict, key, scale: float, stale) -> dict:
    """White noise at ``scale`` times each leaf's per-client RMS; leaf i of
    the reference's tree order draws from ``split(key, L)[i]`` over the
    whole (K, ...) leaf."""
    names = jax_leaf_order(deltas)
    lkeys = keys_lib.split(key.cpu(), len(names))
    d32s, scales = [], []
    for name in names:
        d32 = deltas[name].float()
        axes = tuple(range(1, d32.dim()))
        rms = torch.sqrt(d32.square().mean(dim=axes) + 1e-12)
        d32s.append(d32)
        scales.append(scale * rms)
    out = dict(zip(names, threefry_normal.normal_axpy(d32s, lkeys, scales)))
    return {name: out[name] for name in deltas}


@register_corruption("zero")
def zero(deltas: dict, key, scale: float, stale) -> dict:
    """An all-zero update that still claims its n_k and pays its bytes."""
    return {n: torch.zeros_like(d) for n, d in deltas.items()}


@register_corruption("stale")
def stale_replay(deltas: dict, key, scale: float, stale) -> dict:
    """scale times the client's last honest delta from the cache."""
    if stale is None:
        raise ValueError("stale corruption replays from the server state's delta cache "
                         "(ServerState.stale), which init_server_state only allocates when "
                         "plan.corruption.kind == 'stale'")
    return {n: scale * s for n, s in stale.items()}


# ----------------------------------------------------------------------
# The composed stage: (key, deltas, pmask, stale) -> (deltas', cmask, stale')
# ----------------------------------------------------------------------

def identity_corruption(key, deltas: dict, pmask: torch.Tensor, stale: Optional[dict]):
    """The honest plane: no draw, the cache passes through."""
    return deltas, torch.zeros_like(pmask), stale


def _bcast(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def make_corruption_fn(kind: str, rate: float, scale: float):
    """Returns corrupt(key, deltas, pmask, stale) -> (deltas', cmask,
    stale'): ``cmask`` (K,) is the drawn corrupted-client mask times
    ``pmask``; ``stale'`` holds this round's honest deltas of the
    participants and the old entries of the others."""
    if kind in ("none", "label_shuffle"):
        return identity_corruption
    fn = get_corruption(kind)

    def corrupt(key, deltas: dict, pmask: torch.Tensor, stale: Optional[dict]):
        K = pmask.shape[0]
        mkey, nkey = keys_lib.split(key, 2)
        drawn = (keys_lib.uniform(mkey, (K,)) < rate).float().to(pmask.device)
        cmask = drawn * pmask
        bad = fn(deltas, nkey, scale, stale)
        out = {n: torch.where(_bcast(cmask, d) > 0, bad[n].float(), d.float())
               for n, d in deltas.items()}
        new_stale = stale
        if stale is not None:
            new_stale = {n: torch.where(_bcast(pmask, d) > 0, d.float(), stale[n])
                         for n, d in deltas.items()}
        return out, cmask, new_stale

    return corrupt
