"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's ``repro/models/moe.py``, JAX's parameters carried across: the
routing (``_route``'s expert ids, ``_dispatch_row``'s slots, keep mask,
tokens and gates) held exactly, and ``moe_apply``'s output, aux loss and
gradients at a stated tolerance. Three cases: experts past their capacity
(a small ``capacity_factor``: pairs dropped to slot E·C), shared experts
(``n_shared > 0``), and ties in the router's probabilities (two experts
with the same router column: ``jax.lax.top_k`` takes the lower index, and
so must the port's stable sort)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe

# fp32: the same products summed in another order (a few 1e-7 seen),
# relative to the largest entry of the output (at least 1)
TOL = 1e-5
GRAD_TOL = 1e-5
B, S, D = 2, 12, 16

CASES = {
    "overflow": tmoe.MoEConfig(n_experts=4, top_k=2, expert_ff=24, capacity_factor=0.5),
    "shared": tmoe.MoEConfig(n_experts=4, top_k=2, expert_ff=24, n_shared=2,
                             capacity_factor=1.25),
    "tie": tmoe.MoEConfig(n_experts=6, top_k=2, expert_ff=24, capacity_factor=2.0,
                          renormalize=False),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    cfg = CASES[request.param]
    jcfg = jmoe.MoEConfig(**dataclasses.asdict(cfg))
    jp = jax.tree.map(np.array, jmoe.moe_init(jax.random.PRNGKey(4), D, jcfg))
    x = np.random.default_rng(11).standard_normal((B, S, D)).astype(np.float32)
    if request.param == "tie":
        # experts 1 and 3 share a router column, scaled up so that the tied
        # pair is often the top two
        jp["router"][:, 1] *= 4.0
        jp["router"][:, 3] = jp["router"][:, 1]
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * S * K / E))
    C = min(C, S * K)
    cot = np.random.default_rng(12).standard_normal((B, S, D)).astype(np.float32)

    @jax.jit
    def reference(p, xx, ct):
        probs, gates, idx = jmoe._route(xx @ p["router"], jcfg)
        dispatch = jax.vmap(lambda xr, gr, er: jmoe._dispatch_row(xr, gr, er, E, C))(
            xx, gates, idx)
        (out, aux), vjp = jax.vjp(lambda pp, x2: jmoe.moe_apply(pp, jcfg, x2), p, xx)
        gp, gx = vjp((ct, jnp.float32(1.0)))
        return (probs, gates, idx), dispatch, out, aux, gp, gx

    (probs, gates, idx), (buf, slot, keep, st, sg), out, aux, gp, gx = reference(jp, x, cot)
    return {"name": request.param, "cfg": cfg, "jp": jp, "x": x, "C": C,
            "route": tuple(np.asarray(a) for a in (probs, gates, idx)),
            "dispatch": tuple(np.asarray(a) for a in (buf, slot, keep, st, sg)),
            "out": np.asarray(out), "aux": float(aux), "cot": cot,
            "gp": params_from_jax(jax.tree.map(np.asarray, gp)), "gx": np.asarray(gx)}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max() / max(np.abs(want).max(), 1.0))


def test_capacity_is_the_references(case):
    assert tmoe.capacity(case["cfg"], S) == case["C"]
    if case["name"] == "overflow":
        assert case["C"] == 3 and not case["dispatch"][2].all()  # pairs were dropped


def test_route_is_the_references_exactly(case):
    params = params_from_jax(case["jp"])
    logits = torch.from_numpy(case["x"]) @ params["router"]
    probs, gates, idx = tmoe._route(logits, case["cfg"])
    jprobs, jgates, jidx = case["route"]
    assert np.array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=TOL, atol=1e-7)
    np.testing.assert_allclose(gates.numpy(), jgates, rtol=TOL, atol=1e-7)
    if case["name"] == "tie":
        tied = np.abs(jprobs[..., 1] - jprobs[..., 3]) == 0
        assert tied.all()
        # wherever both tied experts are chosen, the lower index comes first
        both = (jidx == 1).any(-1) & (jidx == 3).any(-1)
        assert both.any() and (jidx[both] == [1, 3]).all()


def test_dispatch_slots_keep_and_order_are_the_references_exactly(case):
    jbuf, jslot, jkeep, jst, jsg = case["dispatch"]
    idx = torch.from_numpy(case["route"][2].astype(np.int64))
    gates = torch.from_numpy(case["route"][1].copy())
    E = case["cfg"].n_experts
    buf, slot, keep, st, sg = tmoe._dispatch_row(torch.from_numpy(case["x"]), gates, idx, E,
                                                 case["C"])
    assert np.array_equal(slot.numpy(), jslot)
    assert np.array_equal(keep.numpy(), jkeep)
    assert np.array_equal(st.numpy(), jst)
    assert np.array_equal(sg.numpy(), jsg)
    assert np.array_equal(buf.numpy(), jbuf)  # copies of x's rows: exact
    assert (slot.numpy()[~jkeep] == E * case["C"]).all()


def _nested(flat: dict) -> dict:
    """{"shared.w_up": t} -> {"shared": {"w_up": t}}: the layer's tree, as
    the transformer hands it to ``moe_apply``."""
    out = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return out


def test_moe_apply_output_aux_and_gradients_match_jax(case):
    params = {k: v.requires_grad_() for k, v in params_from_jax(case["jp"]).items()}
    x = torch.from_numpy(case["x"]).requires_grad_()
    out, aux = tmoe.moe_apply(_nested(params), case["cfg"], x)
    assert _rel(out, case["out"]) <= TOL
    np.testing.assert_allclose(float(aux.detach()), case["aux"], rtol=TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(case["cot"])).sum() + aux,
                                [x, *params.values()])
    assert _rel(grads[0], case["gx"]) <= GRAD_TOL
    assert set(params) == set(case["gp"])
    for name, g in zip(params, grads[1:]):
        assert _rel(g, case["gp"][name].numpy()) <= GRAD_TOL, name


def test_init_shapes_and_dtypes_are_the_references(case):
    tree = tmoe.moe_init(torch.Generator().manual_seed(0), D, case["cfg"], torch.bfloat16)
    mine = {f"{k}.{j}": t for k, v in tree.items() if isinstance(v, dict) for j, t in v.items()}
    mine.update({k: v for k, v in tree.items() if not isinstance(v, dict)})
    ref = jmoe.moe_init(jax.random.PRNGKey(0), D, jmoe.MoEConfig(**dataclasses.asdict(
        case["cfg"])), jnp.bfloat16)
    want = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), ref))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert mine["router"].dtype == torch.float32  # the router is kept in fp32
    assert all(v.dtype == torch.bfloat16 for k, v in mine.items() if k != "router")
