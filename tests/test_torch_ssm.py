"""The port's Mamba2 block (``repro_torch/models/ssm.py``) and K13's plain
versions against the JAX package's, JAX's parameters carried across by
``params_from_jax``, in fp32.

- K13's plain forward and backward (``ref.ssm_scan_fwd_ref``,
  ``ref.ssm_scan_bwd_ref`` through ``SSMScanFunction``) against the
  reference's scan step (``repro/models/ssm.py:110-116``) run by its
  ``chunked_scan`` and differentiated by ``jax.vjp``: from a zero state
  inside one checkpoint chunk, and from a given state across two;
- ``mamba_forward`` and ``mamba_forward_chunked`` (chunks of 5, 8 and the
  whole sequence): the output and every parameter's gradient, compared
  where the reference's are finite as ``tests/test_models_consistency.py``
  does (the scan's VJP can underflow to NaN through long decay products);
- ``mamba_step`` streamed token by token against ``mamba_forward`` (the
  reference's ``test_mamba_step_streams_forward``, atol 2e-5) and against
  the reference's ``mamba_step``, state and all;
- the softplus is the reference's ``logaddexp(x, 0)``, not ``F.softplus``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.layers import chunked_scan as jax_chunked_scan
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ref
from repro_torch.kernels.ssm_scan import CHUNK, SSMScanFunction, ssm_scan
from repro_torch.models import ssm as tssm

# K13's plain versions against JAX's scan, relative to each output's largest
# entry: fp32 sums of the same products in another order over up to 128 steps
SCAN_TOL = 2e-6
# the block's output (~1) and each gradient relative to its largest entry (at
# least 1): a conv, the recurrence, a gated RMSNorm and two projections
TOL = 1e-5
GRAD_TOL = 2e-5
STREAM_ATOL = 2e-5       # the reference's test_mamba_step_streams_forward
CFG = dict(d_model=32, headdim=16, d_state=8)


def _held(got, want, what: str, tol: float):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = np.isfinite(want)
    err = np.abs(got - want)[finite].max(initial=0.0) / max(np.abs(want[finite]).max(initial=0.0),
                                                            1.0)
    assert err <= tol, (what, err)


def _jax_scan(x, dt, a, Bm, Cm, h0):
    """The reference's step (``repro/models/ssm.py:110-116``) through its
    ``chunked_scan`` (chunk 64), on (B, S, ...) inputs."""
    def step(h, inp):
        x_t, B_t, C_t, dec_t, dt_t = inp
        h = h * dec_t[..., None, None] + (dt_t[..., None] * x_t)[..., None] \
            * B_t[:, None, None, :]
        return h, jnp.einsum("bhpn,bn->bhp", h, C_t)

    xs = tuple(t.swapaxes(0, 1) for t in (x, Bm, Cm, a, dt))
    hn, ys = jax_chunked_scan(step, h0, xs, chunk=64)
    return ys.swapaxes(0, 1), hn


def _vjp(fn):
    """(primals..., cotangents...) -> (fn(*primals), its vjp at the
    cotangents), one cotangent for each of fn's two outputs."""
    def run(*args):
        out, vjp = jax.vjp(fn, *args[:-2])
        return out, vjp(tuple(args[-2:]))

    return run


@pytest.mark.parametrize("shape,from_state", [((2, 12, 3, 8, 4), False),
                                              ((2, 128, 2, 4, 8), True)],
                         ids=["one-chunk-from-zero", "two-chunks-from-a-state"])
def test_k13_plain_versions_are_the_references_scan_step(shape, from_state):
    Bs, Ss, H, P, N = shape
    rng = np.random.default_rng(5)
    x = rng.normal(size=(Bs, Ss, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bs, Ss, H)) * 0.5 - 3.0)).astype(np.float32)
    a = np.exp(dt * -np.linspace(1.0, 16.0, H)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(Bs, Ss, N)).astype(np.float32) for _ in range(2))
    h0 = (rng.normal(size=(Bs, H, P, N)) * 0.1 if from_state
          else np.zeros((Bs, H, P, N))).astype(np.float32)
    dy = rng.normal(size=(Bs, Ss, H, P)).astype(np.float32)
    dh = rng.normal(size=(Bs, H, P, N)).astype(np.float32)
    (y, hn), want_grads = jax.jit(_vjp(_jax_scan))(x, dt, a, Bm, Cm, h0, dy, dh)

    ins = [torch.from_numpy(t).requires_grad_(True) for t in (x, dt, a, Bm, Cm, h0)]
    ty, th = SSMScanFunction.apply(*ins)
    _held(ty, y, "y", SCAN_TOL)
    _held(th, hn, "h_T", SCAN_TOL)
    grads = torch.autograd.grad((ty, th), ins, (torch.from_numpy(dy), torch.from_numpy(dh)))
    for name, got, want in zip(("dx", "ddt", "da", "dB", "dC", "dh0"), grads, want_grads):
        _held(got, want, name, SCAN_TOL)
    _, _, ck = ref.ssm_scan_fwd_ref(*(torch.from_numpy(t) for t in (x, dt, a, Bm, Cm, h0)),
                                    CHUNK)
    assert ck.shape == (Bs, H, -(-Ss // CHUNK), P, N)
    with torch.no_grad():
        y2, h2 = ssm_scan(*(torch.from_numpy(t) for t in (x, dt, a, Bm, Cm, h0)))
    assert torch.equal(y2, ty.detach()) and torch.equal(h2, th.detach())


@pytest.fixture(scope="module")
def block():
    cfg = jssm.MambaConfig(**CFG)
    jp = jax.tree.map(np.asarray, jssm.mamba_init(jax.random.PRNGKey(2), cfg))
    x = np.random.default_rng(11).normal(size=(2, 40, 32)).astype(np.float32)
    return {"jcfg": cfg, "cfg": tssm.MambaConfig(**CFG), "jp": jp, "x": x}


@pytest.mark.parametrize("chunk", [None, 5, 8, 40], ids=["scan", "ssd5", "ssd8", "ssd40"])
def test_mamba_forward_and_gradients_match_jax(block, chunk):
    jcfg, cfg, x = block["jcfg"], block["cfg"], block["x"]

    def jfwd(p, xx):
        if chunk is None:
            return jssm.mamba_forward(p, jcfg, xx)
        return jssm.mamba_forward_chunked(p, jcfg, xx, chunk=chunk)

    dy = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(p, xx, cot):
        y, vjp = jax.vjp(jfwd, p, xx)
        return y, vjp(cot)

    y, (gp, gx) = fwd_bwd(block["jp"], x, dy)
    params = {k: v.requires_grad_(True) for k, v in params_from_jax(block["jp"]).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tssm.mamba_forward(params, cfg, tx) if chunk is None else \
        tssm.mamba_forward_chunked(params, cfg, tx, chunk=chunk)
    _held(ty, y, "y", TOL)
    grads = torch.autograd.grad(ty, [*params.values(), tx], torch.from_numpy(dy))
    want = params_from_jax(jax.tree.map(np.asarray, gp))
    assert set(want) == set(params)
    for name, g in zip([*params, "x"], grads):
        assert torch.isfinite(g).all(), name
        _held(g, want[name] if name != "x" else gx, name, GRAD_TOL)


def test_mamba_step_streams_forward_and_matches_jax(block):
    jcfg, cfg, x = block["jcfg"], block["cfg"], block["x"][:, :10]
    params = params_from_jax(block["jp"])
    with torch.no_grad():
        full = tssm.mamba_forward(params, cfg, torch.from_numpy(x))
        state = tssm.mamba_init_state(cfg, 2, device="cpu")
        jstate = jssm.mamba_init_state(jcfg, 2)
        jstep = jax.jit(lambda p, xx, st: jssm.mamba_step(p, jcfg, xx, st))
        ys = []
        for t in range(x.shape[1]):
            y, state = tssm.mamba_step(params, cfg, torch.from_numpy(x[:, t:t + 1]), state)
            jy, jstate = jstep(block["jp"], x[:, t:t + 1], jstate)
            _held(y, jy, f"step {t}", TOL)
            ys.append(y[:, 0])
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), full.numpy(), atol=STREAM_ATOL)
    _held(state["ssm"], jstate["ssm"], "ssm state", TOL)
    for k in ("x", "bc"):
        _held(state["conv"][k], jstate["conv"][k], f"conv state {k}", TOL)
        assert state["conv"][k].dtype == torch.float32


def test_softplus_is_logaddexp_not_the_thresholded_one():
    v = torch.tensor([-30.0, -1.0, 0.0, 5.0, 20.5, 25.0, 90.0])
    got = tssm.softplus(v)
    want = np.asarray(jax.nn.softplus(jnp.asarray(v.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    # F.softplus returns x itself above its threshold of 20
    assert torch.equal(torch.nn.functional.softplus(v)[4:], v[4:])


def test_k13_wrapper_checks_shapes_and_takes_the_plain_version_on_the_cpu():
    from repro_torch.kernels import ssm_scan as K13

    x, dt, Bm = torch.randn(2, 5, 3, 4), torch.rand(2, 5, 3), torch.randn(2, 5, 6)
    before = (K13.FWD_LAUNCHES, K13.BWD_LAUNCHES)
    y, hT, ck = K13.ssm_scan_fwd(x, dt, dt, Bm, Bm, checkpoints=True)
    grads = K13.ssm_scan_bwd(x, dt, dt, Bm, Bm, ck, torch.ones_like(x))
    assert (K13.FWD_LAUNCHES, K13.BWD_LAUNCHES) == before  # no kernel ran
    assert y.shape == x.shape and hT.shape == (2, 3, 4, 6) and ck.shape == (2, 3, 1, 4, 6)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in (x, dt, dt, Bm, Bm, hT)]
    with pytest.raises(ValueError, match="do not"):
        K13.ssm_scan_fwd(x, dt[:, :4], dt, Bm, Bm)
    with pytest.raises(ValueError, match="h0 must be"):
        K13.ssm_scan_fwd(x, dt, dt, Bm, Bm, torch.zeros(2, 3, 4, 5))
    with pytest.raises(ValueError, match="do not fit"):
        K13.ssm_scan_bwd(x, dt, dt, Bm, Bm, ck[..., :5], torch.ones_like(x))
    # the backward's block at every pair of widths: 8 state entries a
    # thread, in the shared memory of one H100 block
    for P in K13.WIDTHS:
        for N in K13.WIDTHS:
            geo = K13.bwd_geometry(P, N)
            assert geo["threads"] == P * N // 8 == 32 * geo["warps"] <= 1024
            assert geo["shared_bytes"] <= K13.SMEM_LIMIT
    with pytest.raises(ValueError, match="P and N in"):
        K13.bwd_geometry(64, 8)


@pytest.mark.parametrize("P", [16, 32, 64])
@pytest.mark.parametrize("N", [16, 32, 64])
def test_k13_forward_block_at_every_pair_of_widths(P, N):
    """The forward's block: a block's rows (at most FWD_LINES) each over N/8
    lanes, up to FWD_ROWS rows a thread in whole warps, the blocks of a
    (b, h) covering its P rows, in the shared memory of one H100 block."""
    from repro_torch.kernels import ssm_scan as K13

    geo = K13.fwd_geometry(P, N)
    lines = min(P, K13.FWD_LINES)
    assert geo["threads"] * min(K13.FWD_ROWS, lines * N // 256) == lines * N // 8
    assert geo["threads"] % 32 == 0
    assert geo["blocks"] * lines == P
    assert geo["shared_bytes"] <= K13.SMEM_LIMIT


@pytest.mark.parametrize("P, N", [(48, 64), (64, 48)])
def test_k13_forward_block_refuses_width_48(P, N):
    from repro_torch.kernels import ssm_scan as K13

    with pytest.raises(ValueError, match="P and N in"):
        K13.fwd_geometry(P, N)
