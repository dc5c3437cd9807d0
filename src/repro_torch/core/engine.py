"""RoundEngine — the port's single entry point to a round engine.

The port of ``repro/core/engine.py``'s ``build_round_engine`` for the
``fedavg``, ``fedsgd`` and ``async`` engines. The plan's fields are
validated when it is built (``FederatedPlan.__post_init__``), and the
engine-capability checks when the engine is built: the async buffer's
(``validate_plan``, ``repro/core/engine.py:82-93``) here, the fedsgd
refusals when ``make_round_step`` builds the round. So an engine exists
only for a plan the port runs in full.
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
    # (state, batch) -> (state, metrics); the async engine's step writes
    # the state's buffer in place, so its input state is consumed: keep
    # only the state it returns
    step: Callable


def validate_plan(plan: FederatedPlan) -> None:
    """The async engine's capability checks, with the reference's
    messages."""
    if plan.engine == "async":
        if plan.asynchrony.buffer_size < 0:
            raise ValueError(
                f"async buffer_size must be >= 0 (0 resolves to K), got "
                f"{plan.asynchrony.buffer_size}")
        if plan.asynchrony.staleness_beta < 0:
            raise ValueError(
                "staleness_beta < 0 would UP-weight stale deltas, got "
                f"{plan.asynchrony.staleness_beta}")


def build_round_engine(plan: FederatedPlan, task: FederatedTask, seed: int) -> RoundEngine:
    """``PRNGKey(seed)`` is the round's threefry base key, as the
    reference's ``base_key`` is: every client step's key (FVN noise and
    SpecAugment masks) and the server plane's keys derive from it."""
    validate_plan(plan)
    return RoundEngine(
        plan=plan,
        init_state=functools.partial(init_server_state, plan),
        step=make_round_step(task.loss_fn, plan, seed),
    )
