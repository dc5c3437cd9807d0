"""RoundEngine — the port's single entry point to a round engine.

The port of ``repro/core/engine.py``'s ``build_round_engine`` for the
``fedavg`` and ``fedsgd`` engines. The plan's fields are validated when
it is built (``FederatedPlan.__post_init__``), and the engine-capability
checks (the fedsgd refusals of ``repro/core/engine.py:71-93``) when
``make_round_step`` builds the round, so an engine exists only for a plan
the port runs in full.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

from repro_torch.core.fedavg import init_server_state, make_round_step
from repro_torch.core.plan import FederatedPlan
from repro_torch.core.task import FederatedTask


class RoundEngine(NamedTuple):
    plan: FederatedPlan
    init_state: Callable  # (params) -> ServerState
    step: Callable        # (state, batch) -> (state, metrics)


def build_round_engine(plan: FederatedPlan, task: FederatedTask, seed: int) -> RoundEngine:
    """``PRNGKey(seed)`` is the round's threefry base key, as the
    reference's ``base_key`` is: every client step's key (FVN noise and
    SpecAugment masks) and the server plane's keys derive from it."""
    return RoundEngine(
        plan=plan,
        init_state=functools.partial(init_server_state, plan),
        step=make_round_step(task.loss_fn, plan, seed),
    )
