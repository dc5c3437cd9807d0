"""The rest of the port's optimizers and schedules against the JAX
package's: five steps of momentum (plain and Nesterov), adamw, yogi,
clip_by_global_norm, chain and scale_by_schedule over a three-leaf
parameter dict made from a numpy seed, with a constant and a scheduled
learning rate, and the schedules linear_ramp_to and piecewise at every
count. Both sides take the same gradients each step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim

# five fp32 steps of elementwise updates, two packages' orders of the same
# operations (and the global norm's sums in another order)
RTOL = 1e-6
ATOL = 1e-9  # entries that cancel to about 0
STEPS = 5
SHAPES = {"enc.w": (7, 5), "bias": (5,), "joint.out": (3, 4, 2)}


def _params_and_grads(seed: int = 0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _run(opt, params, grads, to, back):
    """``STEPS`` updates and applications: the parameters after each."""
    p = to(params)
    state = opt.init(p)
    out = []
    for g in grads:
        upd, state = opt.update(to(g), state, p)
        p = (joptim if to is _jax else toptim).apply_updates(p, upd)
        out.append(back(p))
    return out


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np_from_jax(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _np_from_torch(tree):
    return {k: v.numpy() for k, v in tree.items()}


def _make(lib, name: str, sched: bool):
    lr = lib.linear_rampup_exp_decay(0.05, 2, 3, 0.8) if sched else 0.05
    return {
        "momentum": lambda: lib.momentum(lr, decay=0.85),
        "nesterov": lambda: lib.momentum(lr, decay=0.9, nesterov=True),
        "adamw": lambda: lib.adamw(lr, weight_decay=0.02),
        "yogi": lambda: lib.yogi(lr),
        "clip_sgd": lambda: lib.clip_by_global_norm(lib.sgd(lr), max_norm=0.5),
        "clip_yogi": lambda: lib.clip_by_global_norm(lib.yogi(lr), max_norm=100.0),
        "chain": lambda: lib.chain(lib.scale_by_schedule(lib.linear_ramp_to(2.0, 3, 0.5)),
                                   lib.momentum(lr, nesterov=True)),
        "scale_by_schedule": lambda: lib.chain(
            lib.scale_by_schedule(lib.piecewise([1, 3], [1.0, 0.5, 0.25])), lib.sgd(lr)),
    }[name]()


@pytest.mark.parametrize("sched", [False, True], ids=["constant lr", "scheduled lr"])
@pytest.mark.parametrize("name", ["momentum", "nesterov", "adamw", "yogi", "clip_sgd",
                                  "clip_yogi", "chain", "scale_by_schedule"])
def test_five_steps_match_jax(name, sched):
    params, grads = _params_and_grads()
    want = _run(_make(joptim, name, sched), params, grads, _jax, _np_from_jax)
    got = _run(_make(toptim, name, sched), params, grads, _torch, _np_from_torch)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in SHAPES:
            assert g[k].dtype == w[k].dtype == np.float32
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {step} {k}")
    moved = max(float(np.abs(got[-1][k] - params[k]).max()) for k in SHAPES)
    assert moved > 1e-3, name


def test_clip_scales_only_above_the_norm():
    """Above max_norm the gradients are scaled to it; below, untouched."""
    _, grads = _params_and_grads(1)
    g = _torch(grads[0])
    norm = float(toptim.global_norm(g))
    np.testing.assert_allclose(norm, float(joptim.global_norm(_jax(grads[0]))), rtol=RTOL)
    for max_norm, scale in ((norm / 4, 0.25), (norm * 4, 1.0)):
        opt = toptim.clip_by_global_norm(toptim.sgd(1.0), max_norm)
        upd, _ = opt.update(g, opt.init(g))
        for k in SHAPES:
            np.testing.assert_allclose(upd[k].numpy(), -scale * g[k].numpy(), rtol=RTOL)


@pytest.mark.parametrize("schedule", [
    ("linear_ramp_to", (0.03, 5)), ("linear_ramp_to", (0.7, 3, 0.1)),
    ("linear_ramp_to", (0.02, 0)), ("piecewise", ([2, 5, 9], [0.1, 0.03, 0.007, 1e-4])),
    ("piecewise", ([], [0.5])),
])
def test_schedules_match_jax_exactly(schedule):
    name, args = schedule
    j, t = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for count in range(12):
        assert t(count) == float(j(count)), (name, args, count)
