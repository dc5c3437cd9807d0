"""K3/K4 (the fused RNN-T joint): the port's plain versions and autograd
Function against the JAX package's Pallas kernels in interpret mode, its
dense oracle and the VJP of its chunked joint.

On the CPU the port's wrappers take the plain versions, so these tests
hold the arithmetic the CUDA kernels must reproduce; ``chip_smoke.py``
holds the kernels themselves against the plain versions on the card.
The Pallas kernels take only shapes with T % min(16, T) == 0,
U1 % min(8, U1) == 0 and V % min(512, V) == 0 (ROADMAP F4); ragged
shapes are held to the oracles instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import _joint_ref_chunked
from repro.kernels.rnnt_joint import rnnt_joint_bwd_fused, rnnt_joint_fused
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rnnt_joint as K

# fp32 forward: J-term dot products and a V-term log-sum-exp, summed in
# another order than XLA's; log-probs of magnitude ~5.
FWD_ATOL = 2e-5
# fp32 backward, compared relative to each gradient's largest entry (as
# tests/test_kernels.py does for the Pallas backward).
BWD_REL_ATOL = 5e-5

# the shapes of tests/test_kernels.py:332-337: (B, T, U1, J, V, tq, tu, tv)
PALLAS_SHAPES = [
    (2, 32, 16, 24, 64, 16, 8, 32),
    (1, 16, 8, 16, 128, 8, 4, 64),
    (2, 24, 12, 8, 48, 8, 4, 16),
    (1, 64, 8, 32, 256, 16, 8, 128),
]
# ragged shapes: the tiny corpus's lattice (T=24, U1=13) and the paper
# width's U1=33, with a V that no slab divides
RAGGED_SHAPES = [(3, 24, 13, 16, 40), (2, 24, 33, 8, 72)]


def _inputs(B, T, U1, J, V, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, T, J)).astype(np.float32),
            r.standard_normal((B, U1, J)).astype(np.float32),
            (r.standard_normal((J, V)) * 0.3).astype(np.float32),
            (r.standard_normal((V,)) * 0.1).astype(np.float32),
            r.integers(0, V, (B, U1)).astype(np.int32))


def _cotangents(B, T, U1, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, T, U1)).astype(np.float32),
            r.standard_normal((B, T, U1)).astype(np.float32))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _assert_rel(got, want, name):
    want = np.asarray(want)
    denom = float(np.abs(want).max()) + 1e-30
    np.testing.assert_allclose(np.asarray(got) / denom, want / denom, atol=BWD_REL_ATOL, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("B,T,U1,J,V,tq,tu,tv", PALLAS_SHAPES)
def test_plain_forward_matches_pallas(B, T, U1, J, V, tq, tu, tv):
    arrays = _inputs(B, T, U1, J, V, seed=B * T + V)
    got = K.rnnt_joint_fwd(*_torch(*arrays))
    want = rnnt_joint_fused(*map(jnp.asarray, arrays), tq=tq, tu=tu, tv=tv, interpret=True,
                            return_lse=True)
    for name, a, b in zip(("blank", "label", "lse"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("B,T,U1,J,V", RAGGED_SHAPES)
def test_plain_forward_matches_dense_oracle_at_ragged_shapes(B, T, U1, J, V):
    arrays = _inputs(B, T, U1, J, V, seed=U1)
    blank, label, lse = K.rnnt_joint_fwd(*_torch(*arrays))
    want_blank, want_label = jref.rnnt_joint_ref(*map(jnp.asarray, arrays))
    e, g, w, b, _ = arrays
    h = np.tanh(e[:, :, None, :].astype(np.float64) + g[:, None, :, :])
    logits = h @ w + b
    mx = logits.max(-1)
    want_lse = mx + np.log(np.exp(logits - mx[..., None]).sum(-1))
    np.testing.assert_allclose(blank.numpy(), np.asarray(want_blank), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(label.numpy(), np.asarray(want_label), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("B,T,U1,J,V,tq,tu,tv", PALLAS_SHAPES)
def test_plain_backward_matches_pallas(B, T, U1, J, V, tq, tu, tv):
    arrays = _inputs(B, T, U1, J, V, seed=B * T + V)
    dbl, dlb = _cotangents(B, T, U1, seed=9)
    jarrays = tuple(map(jnp.asarray, arrays))
    _, _, lse = rnnt_joint_fused(*jarrays, tq=tq, tu=tu, tv=tv, interpret=True,
                                 return_lse=True)
    want = rnnt_joint_bwd_fused(*jarrays, lse, jnp.asarray(dbl), jnp.asarray(dlb),
                                tq=tq, tu=tu, tv=tv, interpret=True)
    got = K.rnnt_joint_bwd(*_torch(*arrays, np.array(lse), dbl, dlb))
    for name, a, b in zip(("de", "dg", "dw", "db"), got, want):
        assert a.dtype == torch.float32
        _assert_rel(a.numpy(), b, name)


@pytest.mark.parametrize("B,T,U1,J,V", RAGGED_SHAPES)
def test_plain_backward_matches_chunked_vjp_at_ragged_shapes(B, T, U1, J, V):
    arrays = _inputs(B, T, U1, J, V, seed=U1 + 1)
    dbl, dlb = _cotangents(B, T, U1, seed=U1)
    e, g, w, b, lbl = map(jnp.asarray, arrays)
    _, vjp = jax.vjp(lambda e_, g_, w_, b_: _joint_ref_chunked(e_, g_, w_, b_, lbl), e, g, w, b)
    want = vjp((jnp.asarray(dbl), jnp.asarray(dlb)))
    _, _, lse = K.rnnt_joint_fwd(*_torch(*arrays))
    got = K.rnnt_joint_bwd(*_torch(*arrays), lse, *_torch(dbl, dlb))
    for name, a, b in zip(("de", "dg", "dw", "db"), got, want):
        _assert_rel(a.numpy(), b, name)


def test_autograd_function_gradcheck_float64():
    r = np.random.default_rng(4)
    B, T, U1, J, V = 2, 3, 4, 5, 7
    e, g = (torch.from_numpy(r.standard_normal(s)).requires_grad_()
            for s in ((B, T, J), (B, U1, J)))
    w = torch.from_numpy(r.standard_normal((J, V)) * 0.5).requires_grad_()
    b = torch.from_numpy(r.standard_normal(V) * 0.1).requires_grad_()
    labels = torch.from_numpy(r.integers(0, V, (B, U1)).astype(np.int32))
    assert torch.autograd.gradcheck(lambda *x: K.rnnt_joint(*x, labels), (e, g, w, b),
                                    eps=1e-6, atol=1e-7)


def test_autograd_returns_gradients_in_the_input_dtypes():
    """bf16 e and g (the paper width's compute dtype) with fp32 W and b:
    de and dg come back in bf16, dW and db in fp32, as ops.py:114-120."""
    arrays = _inputs(2, 4, 3, 8, 16, seed=1)
    e, g, w, b, lbl = _torch(*arrays)
    e, g = (x.to(torch.bfloat16).requires_grad_() for x in (e, g))
    w, b = w.requires_grad_(), b.requires_grad_()
    blank, label = K.rnnt_joint(e, g, w, b, lbl)
    assert blank.dtype == label.dtype == torch.float32
    grads = torch.autograd.grad((blank.sum() + 2 * label.sum()), (e, g, w, b))
    assert [x.dtype for x in grads] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                        torch.float32]


@pytest.mark.parametrize("case", ["g_shape", "w_shape", "labels_shape", "lse_shape",
                                  "float_labels", "mixed_dtypes", "meta_device"])
def test_wrapper_refuses_bad_inputs(case):
    e, g, w, b, lbl = _torch(*_inputs(2, 4, 3, 8, 16, seed=2))
    lse = torch.zeros(2, 4, 3)
    call, error = (lambda: K.rnnt_joint_fwd(e, g, w, b, lbl)), ValueError
    if case == "g_shape":
        g = g[:, :, :5]
    elif case == "w_shape":
        w = w[:5]
    elif case == "labels_shape":
        lbl = lbl[:, :2]
    elif case == "lse_shape":
        call = lambda: K.rnnt_joint_bwd(e, g, w, b, lbl, lse[:, :2], lse, lse)
    elif case == "float_labels":
        lbl, error = lbl.float(), TypeError
    elif case == "mixed_dtypes":
        g, error = g.double(), TypeError
    elif case == "meta_device":
        e, g, w, b, lbl = (x.to("meta") for x in (e, g, w, b, lbl))
    def counts():
        return (K.FWD_LAUNCHES, K.FWD_H_LAUNCHES, K.FWD_LOGITS_LAUNCHES, K.FWD_LSE_LAUNCHES,
                K.BWD_H_LAUNCHES, K.BWD_DLOGITS_LAUNCHES, K.BWD_DH_LAUNCHES,
                K.BWD_REDUCE_LAUNCHES, K.BWD_DW_LAUNCHES)

    launches = counts()
    with pytest.raises(error):
        call()
    args = _torch(*_inputs(2, 4, 3, 8, 16, seed=2))
    blank, label, lse = K.rnnt_joint_fwd(*args)
    K.rnnt_joint_bwd(*args, lse, blank, label)
    assert counts() == launches  # the plain version is no launch


def _pieces(e, g, w, b, labels, lse, dblank, dlabel):
    """The backward as the card runs it, one plain version a launch: h,
    dlogits, dpre, de and dg, then dW and db."""
    h = tref.rnnt_joint_h_ref(e, g)
    dlogits = tref.rnnt_joint_dlogits_ref(h, w, b, labels, lse, dblank, dlabel)
    return (*tref.rnnt_joint_bwd_reduce_ref(tref.rnnt_joint_dpre_ref(dlogits, w, h)),
            *tref.rnnt_joint_dw_ref(h, dlogits))


@pytest.mark.parametrize("B,T,U1,J,V,tq,tu,tv", PALLAS_SHAPES)
def test_plain_backward_pieces_match_pallas(B, T, U1, J, V, tq, tu, tv):
    """The five launches' plain versions, composed, against the Pallas
    backward in interpret mode."""
    arrays = _inputs(B, T, U1, J, V, seed=B * T + V + 1)
    dbl, dlb = _cotangents(B, T, U1, seed=10)
    jarrays = tuple(map(jnp.asarray, arrays))
    _, _, lse = rnnt_joint_fused(*jarrays, tq=tq, tu=tu, tv=tv, interpret=True,
                                 return_lse=True)
    want = rnnt_joint_bwd_fused(*jarrays, lse, jnp.asarray(dbl), jnp.asarray(dlb),
                                tq=tq, tu=tu, tv=tv, interpret=True)
    got = _pieces(*_torch(*arrays, np.array(lse), dbl, dlb))
    for name, a, b in zip(("de", "dg", "dw", "db"), got, want):
        assert a.dtype == torch.float32
        _assert_rel(a.numpy(), b, name)


@pytest.mark.parametrize("B,T,U1,J,V", RAGGED_SHAPES)
def test_plain_backward_pieces_match_chunked_vjp_at_ragged_shapes(B, T, U1, J, V):
    arrays = _inputs(B, T, U1, J, V, seed=U1 + 2)
    dbl, dlb = _cotangents(B, T, U1, seed=U1 + 3)
    e, g, w, b, lbl = map(jnp.asarray, arrays)
    _, vjp = jax.vjp(lambda e_, g_, w_, b_: _joint_ref_chunked(e_, g_, w_, b_, lbl), e, g, w, b)
    want = vjp((jnp.asarray(dbl), jnp.asarray(dlb)))
    _, _, lse = K.rnnt_joint_fwd(*_torch(*arrays))
    got = _pieces(*_torch(*arrays), lse, *_torch(dbl, dlb))
    for name, a, b in zip(("de", "dg", "dw", "db"), got, want):
        _assert_rel(a.numpy(), b, name)


@pytest.mark.parametrize("B,T,U1,J,V", [PALLAS_SHAPES[0][:5], *RAGGED_SHAPES])
def test_plain_dlogits_match_the_vjp_of_jax_log_softmax(B, T, U1, J, V):
    """The dlogits launch's plain version against JAX's VJP of the blank
    and label log-probs of the same logits."""
    arrays = _inputs(B, T, U1, J, V, seed=J + V)
    dbl, dlb = _cotangents(B, T, U1, seed=J)
    e, g, w, b, lbl = _torch(*arrays)
    h = tref.rnnt_joint_h_ref(e, g)
    logits = (h @ w + b).numpy()
    _, _, lse = K.rnnt_joint_fwd(e, g, w, b, lbl)
    got = tref.rnnt_joint_dlogits_ref(h, w, b, lbl, lse, *_torch(dbl, dlb))

    def log_probs(x):
        lp = jax.nn.log_softmax(x, axis=-1)
        idx = jnp.broadcast_to(jnp.asarray(arrays[4])[:, None, :, None], (B, T, U1, 1))
        return lp[..., 0], jnp.take_along_axis(lp, idx, axis=-1)[..., 0]

    _, vjp = jax.vjp(log_probs, jnp.asarray(logits))
    (want,) = vjp((jnp.asarray(dbl), jnp.asarray(dlb)))
    _assert_rel(got.numpy(), want, "dlogits")


@pytest.mark.parametrize("B,T,U1,J,V", [(2, 4, 3, 8, 16), *RAGGED_SHAPES])
def test_plain_backward_pieces_compose_to_the_plain_backward(B, T, U1, J, V):
    """On the CPU the wrapper's backward is the chunked plain version; the
    pieces the card runs compose to it (fp32 sums over another chunking:
    within 1e-6 of each gradient's largest entry)."""
    arrays = _torch(*_inputs(B, T, U1, J, V, seed=7))
    _, _, lse = K.rnnt_joint_fwd(*arrays)
    cot = _torch(*_cotangents(B, T, U1, seed=8))
    want = K.rnnt_joint_bwd(*arrays, lse, *cot)
    got = _pieces(*arrays, lse, *cot)
    for name, a, b in zip(("de", "dg", "dw", "db"), got, want):
        top = float(b.abs().max())
        np.testing.assert_allclose(a.numpy() / top, b.numpy() / top, atol=1e-6, rtol=0,
                                   err_msg=name)
    h = tref.rnnt_joint_h_ref(*arrays[:2])
    assert h.shape == (B, T, U1, J)
    assert tref.rnnt_joint_dlogits_ref(h, *arrays[2:], lse, *cot).shape == (B, T, U1, V)


def _forward_launches(e, g, w, b, labels):
    """K3 as the card runs it, one plain version a launch: h, the logits,
    their log-sum-exp in the kernel's order."""
    h = tref.rnnt_joint_h_ref(e, g)
    return tref.rnnt_joint_lse_ref(tref.rnnt_joint_logits_ref(h, w, b), labels)


@pytest.mark.parametrize("B,T,U1,J,V,tq,tu,tv", PALLAS_SHAPES[:3])
def test_plain_forward_launches_match_pallas(B, T, U1, J, V, tq, tu, tv):
    """K3's three launches' plain versions, composed, against the Pallas
    forward in interpret mode (FWD_ATOL: the same sums in another order)."""
    arrays = _inputs(B, T, U1, J, V, seed=B * T + V + 2)
    got = _forward_launches(*_torch(*arrays))
    want = rnnt_joint_fused(*map(jnp.asarray, arrays), tq=tq, tu=tu, tv=tv, interpret=True,
                            return_lse=True)
    for name, a, b in zip(("blank", "label", "lse"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("B,T,U1,J,V", RAGGED_SHAPES)
def test_plain_forward_launches_match_dense_oracle_at_ragged_shapes(B, T, U1, J, V):
    arrays = _inputs(B, T, U1, J, V, seed=U1)
    blank, label, lse = _forward_launches(*_torch(*arrays))
    want_blank, want_label = jref.rnnt_joint_ref(*map(jnp.asarray, arrays))
    e, g, w, b, _ = arrays
    logits = np.tanh(e[:, :, None, :].astype(np.float64) + g[:, None, :, :]) @ w + b
    mx = logits.max(-1)
    want_lse = mx + np.log(np.exp(logits - mx[..., None]).sum(-1))
    np.testing.assert_allclose(blank.numpy(), np.asarray(want_blank), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(label.numpy(), np.asarray(want_label), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=FWD_ATOL, rtol=0)


def _lse_in_order_numpy(logits, labels):
    """K3's log-sum-exp launch lane by lane in numpy: 128-column slabs in
    order; lane tx of 32 holds columns v0 + tx + 32c, c = 0..3 (-inf past
    V); the slab's max; each lane's sum of exp(x - m') in c order from 0,
    then the xor tree across the lanes; l = fma(l, exp(m - m'), s) (the
    product exact in float64, one rounding there, one to float32); exp and
    log taken in float64 and rounded once to float32."""
    B, T, U1, V = logits.shape
    x = logits.reshape(-1, V).astype(np.float32)
    N = x.shape[0]

    def exp32(a):
        return np.exp(a.astype(np.float64)).astype(np.float32)

    m = np.full(N, -np.inf, np.float32)
    l = np.zeros(N, np.float32)
    for v0 in range(0, V, 128):
        lanes = np.full((N, 32, 4), -np.inf, np.float32)
        for tx in range(32):
            for c in range(4):
                if v0 + tx + 32 * c < V:
                    lanes[:, tx, c] = x[:, v0 + tx + 32 * c]
        nm = np.maximum(m, lanes.max(axis=(1, 2)))
        s = np.zeros((N, 32), np.float32)
        for c in range(4):
            s = s + exp32(lanes[:, :, c] - nm[:, None])
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, np.arange(32) ^ o]
        l = (l.astype(np.float64) * exp32(m - nm) + s[:, 0]).astype(np.float32)
        m = nm
    lse = m + np.log(np.maximum(l, np.float32(1e-30)).astype(np.float64)).astype(np.float32)
    lbl = np.broadcast_to(labels[:, None, :], (B, T, U1)).reshape(-1)
    ok = (lbl >= 0) & (lbl < V)
    at = np.where(ok, x[np.arange(N), np.where(ok, lbl, 0)], np.float32(0.0))
    return tuple(a.reshape(B, T, U1) for a in (x[:, 0] - lse, at - lse, lse))


@pytest.mark.parametrize("B,T,U1,V,scale", [(2, 3, 4, 300, 3.0), (1, 2, 3, 128, 1.0),
                                            (2, 2, 2, 1, 1.0), (1, 3, 2, 129, 20.0),
                                            (1, 2, 5, 1000, 0.1)])
def test_plain_lse_launch_is_its_order_written_out(B, T, U1, V, scale):
    """The log-sum-exp launch's plain version gives the bits of the same
    order written out lane by lane in numpy, labels out of range (-1, V)
    included."""
    r = np.random.default_rng(V)
    logits = (r.standard_normal((B, T, U1, V)) * scale).astype(np.float32)
    labels = r.integers(-1, V + 1, (B, U1)).astype(np.int32)
    labels[0, 0], labels[-1, -1] = -1, V
    got = tref.rnnt_joint_lse_ref(*_torch(logits, labels))
    want = _lse_in_order_numpy(logits, labels)
    for name, a, b in zip(("blank", "label", "lse"), got, want):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), b.view(np.uint32),
                                      err_msg=name)


def test_plain_tanh_is_the_same_on_first_and_second_use():
    """The plain versions' tanh (MKL VML behind ATen on the CPU) was off by
    up to 8.8e-5 on one 2,048-element chunk in about 1 fresh process in
    125 under load, on its first use; ``ref.tanh`` warms every intra-op
    thread first. A handful of fresh processes: h's first and second
    computation agree bit for bit, and with float64's tanh."""
    import os
    import subprocess
    import sys

    code = (
        "import numpy as np, torch\n"
        "from repro_torch.kernels import ref\n"
        "r = np.random.default_rng(0)\n"
        "e = torch.from_numpy((r.standard_normal((2, 32, 24)) * 2).astype(np.float32))\n"
        "g = torch.from_numpy((r.standard_normal((2, 16, 24)) * 2).astype(np.float32))\n"
        "h1, h2 = ref.rnnt_joint_h_ref(e, g), ref.rnnt_joint_h_ref(e, g)\n"
        "want = np.tanh(e.double().numpy()[:, :, None] + g.double().numpy()[:, None])\n"
        "print(bool(torch.equal(h1, h2)), float(np.abs(h1.double().numpy() - want).max()))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                              env=env) for _ in range(4)]
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0
        same, err = out.split()
        assert same == "True" and float(err) < 1e-6, out
