"""The normal kernel's plain versions against JAX: XLA's float32 erf_inv
restated operation by operation (``ref.xla_erf_inv_f32``), the threefry
normal (``ref.threefry_normal_ref``, ``keys.normal``) and the kernel's
scaled sum over a table of leaves (``threefry_normal.normal_axpy``,
``fvn.perturb``). The wrapper takes the plain version here because the
tensors lie on the CPU; chip_smoke.py holds the CUDA kernel to it bit for
bit on the card.

jax.random.normal is sqrt(2) · erf_inv(u) of a uniform u on [lo, 1), and
u takes only 2**23 values (its 23-bit fill times 2 plus lo): the erf_inv
is held on every one of them. Every draw runs with jax_threefry_
partitionable=False (the pinned jax's default; F2a), set and restored by
the ``non_partitionable`` fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fvn as jfvn
from repro_torch.core import fvn, keys
from repro_torch.kernels import ref, threefry_normal

# XLA's CPU program and the plain version give the same bits: no tolerance.
# Under jax.jit, XLA contracts FVN's ``p + sigma * noise`` into one fused
# multiply-add, which the port (and JAX's eager call) takes as two IEEE
# operations: the sum may then move by an ulp of p.
JIT_AXPY_ULPS = 1

FILL_CHUNKS = 4  # the 2**23 uniform values, in chunks


@pytest.fixture
def non_partitionable():
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _uniform_values(chunk: int) -> torch.Tensor:
    """One chunk of the 2**23 float32 values jax.random.normal's uniform
    takes: max(lo, f · 2 + lo) for every 23-bit fill f (the width 1 - lo
    rounds to 2), in fp64 with one rounding, as XLA's fused multiply-add."""
    per = 2**23 // FILL_CHUNKS
    k = torch.arange(chunk * per, (chunk + 1) * per, dtype=torch.float64)
    lo = np.float64(np.float32(ref.NORMAL_LO))
    return torch.clamp((k * 2.0**-22 + lo).float(), min=float(np.float32(lo)))


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _exact_fma32(a, b, c):
    """The correctly rounded fmaf: the fp64 sum of the exact product
    corrected where it lands on a midpoint of two float32 values with a
    rounding error of its own (TwoSum gives that error exactly)."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    down = torch.nextafter(r, torch.tensor(-np.inf))
    up = torch.nextafter(r, torch.tensor(np.inf))
    lo = torch.where(r.double() <= s, r, down)
    hi = torch.where(r.double() >= s, r, up)
    tie = (r.double() != s) & (s == (lo.double() + hi.double()) * 0.5) & (err != 0)
    return torch.where(tie, torch.where(err > 0, hi, lo), r)


@pytest.mark.parametrize("chunk", range(FILL_CHUNKS))
def test_xla_erf_inv_is_jax_erf_inv_on_every_uniform_value(chunk, monkeypatch):
    u = _uniform_values(chunk)
    want = _bits(jax.jit(jax.lax.erf_inv)(u.numpy()))
    got = ref.xla_erf_inv_f32(u)
    np.testing.assert_array_equal(_bits(got), want)
    # each of its fused multiply-adds taken as the correctly rounded fmaf
    # (the kernel's) gives the same bits
    monkeypatch.setattr(ref, "_fma32", _exact_fma32)
    np.testing.assert_array_equal(_bits(ref.xla_erf_inv_f32(u)), want)


def test_erf_inv_polynomial_on_jax_log1p_is_bitwise_in_both_branches():
    """Given JAX's own log1p(-x·x), the polynomial gives XLA's bits, in
    the branch w < 5 and the branch w >= 5."""
    x = np.concatenate([np.linspace(-0.99999994, 0.99999994, 200_001, dtype=np.float32),
                        1.0 - np.float32(2.0) ** -np.arange(8, 25, dtype=np.float32)])
    lg = np.asarray(jax.jit(lambda v: jnp.log1p(v * -v))(x))
    assert (-lg < 5).any() and (-lg >= 5).any()
    got = ref.erf_inv_from_log1p(torch.from_numpy(x), torch.from_numpy(lg))
    np.testing.assert_array_equal(_bits(got), _bits(jax.jit(jax.lax.erf_inv)(x)))


def test_xla_erf_inv_at_the_endpoints():
    """lo, the uniform's least value, and 1 - 2**-24, the float32 below 1
    (w >= 5 for both); 0; and ±1, where erf_inv is ±inf."""
    lo = np.float32(ref.NORMAL_LO)
    x = np.array([lo, 1.0 - 2.0**-24, -(1.0 - 2.0**-24), 0.0, -0.0, 1.0, -1.0], np.float32)
    got = ref.xla_erf_inv_f32(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), _bits(jax.jit(jax.lax.erf_inv)(x)))
    assert torch.isinf(got[-2:]).all() and bool(torch.isfinite(got[:-2]).all())


# and the kernel's run edges (threefry_normal.RUN_EDGES), one of them as
# two rows
NORMAL_SHAPES = ([(1,), (4,), (5,), (64, 513), (1001,), (3, 7)]
                 + [(n,) for n in threefry_normal.RUN_EDGES] + [(2, 2_047)])


@pytest.mark.parametrize("shape", NORMAL_SHAPES)
def test_threefry_normal_and_keys_normal_are_jax_normal_bitwise(non_partitionable, shape):
    for seed, data in ((0, 1), (42, 2**31 + 3), (7, 0x616767)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        want = _bits(jax.random.normal(jkey, shape))
        tkey = keys.fold_in(keys.PRNGKey(seed), data)
        np.testing.assert_array_equal(_bits(keys.normal(tkey, shape)).reshape(want.shape), want)
        n = int(np.prod(shape))
        np.testing.assert_array_equal(_bits(ref.threefry_normal_ref(tkey, n)),
                                      want.reshape(-1))


@pytest.mark.parametrize("n", threefry_normal.RUN_EDGES)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_normal_axpy_at_run_edges_is_jax_bitwise(non_partitionable, n, dtype):
    """The scaled sum at the kernel's run edges, fp32 and bf16 leaves,
    against JAX's ``(x.astype(f32) + sigma * normal).astype(dtype)``."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    kd = keys.split(keys.PRNGKey(n), 2)
    got = threefry_normal.normal_axpy([tx], kd[1:2], [0.01])[0]
    assert got.dtype == tx.dtype
    jz = jax.random.normal(jax.random.wrap_key_data(jnp.asarray(kd[1].numpy().astype(np.uint32))),
                           (n,))
    jx = jnp.asarray(tx.float().numpy())
    want = (jx + jnp.float32(0.01) * jz).astype(getattr(jnp, dtype))
    np.testing.assert_array_equal(_bits(got.float()), _bits(np.asarray(want.astype(jnp.float32))))


@pytest.mark.parametrize("chunk", range(FILL_CHUNKS))
def test_word_normals_on_every_fill_are_jax_normal_bitwise(chunk):
    """word_normals (the kernel's normal over given words; here its plain
    version) of the words f << 9 for every 23-bit fill f: sqrt(2) ·
    erf_inv of the uniform, jax's value of the word, bit for bit."""
    per = 2**23 // FILL_CHUNKS
    fills = torch.arange(chunk * per, (chunk + 1) * per, dtype=torch.int64)
    words = fills << 9
    got = threefry_normal.word_normals(torch.where(words >= 2**31, words - 2**32, words)
                                       .to(torch.int32))
    u = _uniform_values(chunk)
    want = np.float32(np.sqrt(np.float32(2.0))) * np.asarray(jax.jit(jax.lax.erf_inv)(u.numpy()))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_threefry_bits_hash_each_block_once_at_every_position():
    """The hash-once pairing (K5's and the normal kernel's) gives the word
    of every position as hashing each position's own block does, for
    every n up to 600, odd and even."""
    kd = torch.tensor([0x12345678, 0x9ABCDEF0])
    for n in range(1, 601):
        pos = torch.arange(n)
        want = ref.threefry_random_bits_at(kd[0:1], kd[1:2], pos, n)
        assert torch.equal(ref.threefry_bits_ref(kd[0:1], kd[1:2], n), want), n


def _tree(rng):
    """A nested JAX tree mixing fp32 and bf16 leaves, and the port's dict
    of the same tensors under dotted names, in another order."""
    jp = {"w": {"b": jnp.asarray(rng.normal(size=(5,)), jnp.float32),
                "a": jnp.asarray(rng.normal(size=(300, 77)), jnp.bfloat16)},
          "enc": [jnp.asarray(rng.normal(size=(1001,)), jnp.float32),
                  jnp.asarray(rng.normal(size=(64, 33)), jnp.float32),
                  jnp.asarray(rng.normal(size=(3,)), jnp.bfloat16)]}
    flat = {"w.b": jp["w"]["b"], "enc.2": jp["enc"][2], "w.a": jp["w"]["a"],
            "enc.0": jp["enc"][0], "enc.1": jp["enc"][1]}
    tp = {n: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for n, v in flat.items()}
    return jp, tp


def _flat(jtree) -> dict:
    return {"w.b": jtree["w"]["b"], "w.a": jtree["w"]["a"], "enc.0": jtree["enc"][0],
            "enc.1": jtree["enc"][1], "enc.2": jtree["enc"][2]}


@pytest.mark.parametrize("sigma", [0.01, 0.5])
def test_fvn_perturb_is_jax_perturb(non_partitionable, sigma):
    """fvn.perturb against repro.core.fvn.perturb on a tree of fp32 and
    bf16 leaves from the same client-step key: JAX's eager call bit for
    bit (each leaf's key from split in tree order, the draw, the product,
    the sum, the cast back); its jitted call within JIT_AXPY_ULPS of the
    leaf."""
    jp, tp = _tree(np.random.default_rng(0))
    jkey = jfvn.fvn_key(jax.random.PRNGKey(1), 3, 2, 1)
    tkey = fvn.fvn_key(keys.PRNGKey(1), 3, 2, 1)
    got = fvn.perturb(tp, tkey, sigma)
    assert list(got) == list(tp)
    s = jnp.float32(sigma)
    eager = _flat(jfvn.perturb(jp, jkey, s))
    jitted = _flat(jax.jit(jfvn.perturb)(jp, jkey, s))
    for name, g in got.items():
        assert g.dtype == tp[name].dtype and g.shape == tp[name].shape
        want = np.asarray(eager[name].astype(jnp.float32))
        np.testing.assert_array_equal(g.float().numpy(), want, err_msg=name)
        j = np.asarray(jitted[name].astype(jnp.float32))
        # the product's rounding, which the fused form skips, and an ulp
        # of the result in the leaf's dtype (bf16 keeps 16 fewer bits)
        x = tp[name].float().numpy()
        ulp = np.spacing(np.abs(want - x)) + np.spacing(np.abs(j)) * (
            2.0**16 if g.dtype == torch.bfloat16 else 1.0)
        assert (np.abs(want - j) <= JIT_AXPY_ULPS * ulp).all(), name


def test_fvn_noise_differs_across_round_client_and_step_and_scales(non_partitionable):
    _, tp = _tree(np.random.default_rng(1))
    zero = {n: torch.zeros(v.shape) for n, v in tp.items() if v.dtype == torch.float32}
    base = keys.PRNGKey(7)

    def noise(r, k, s, sigma=0.02):
        out = fvn.perturb(zero, fvn.fvn_key(base, r, k, s), sigma)
        return torch.cat([out[n].flatten() for n in zero])

    n = noise(2, 1, 0)
    assert torch.equal(n, noise(2, 1, 0))
    for other in (noise(2, 2, 0), noise(3, 1, 0), noise(2, 1, 1)):
        assert not torch.equal(n, other)
    assert torch.equal(noise(2, 1, 0, 0.04), (n.double() * 2).float())  # a power-of-2 scale
    assert abs(float(n.std()) / 0.02 - 1.0) < 0.05


def test_normal_axpy_scales_equal_slices_from_a_vector(non_partitionable):
    """A (K,) scale scales the K equal slices of the flattened leaf, as
    the gaussian adversary's per-client scale · RMS does; a 0-dim tensor
    scale and a float scale give the same bits."""
    x = torch.randn(4, 6, 5, generator=torch.Generator().manual_seed(0))
    kd = keys.split(keys.PRNGKey(9), 3)
    s = torch.tensor([0.5, 2.0, 0.0, -1.0])
    out = threefry_normal.normal_axpy([x, x, x], kd, [s, torch.tensor(0.25), 0.25])
    z = ref.threefry_normal_ref(kd[0], x.numel()).reshape(4, 30)
    assert torch.equal(out[0], (x.reshape(4, 30) + s[:, None] * z).reshape(x.shape))
    assert torch.equal(out[0][2], x[2])
    again = threefry_normal.normal_axpy([x], kd[1:2], [0.25])[0]
    assert torch.equal(out[1], again)
    jz = jax.random.normal(jax.random.wrap_key_data(jnp.asarray(kd[1].numpy().astype(np.uint32))),
                           (4, 6, 5))
    np.testing.assert_array_equal(_bits(out[1]), _bits(np.float32(x.numpy()) + np.float32(0.25)
                                                       * np.asarray(jz)))


def test_normal_axpy_refuses_bad_tables():
    x = torch.zeros(6)
    kd = keys.split(keys.PRNGKey(1), 2)
    with pytest.raises(ValueError, match="key_data"):
        threefry_normal.normal_axpy([x], kd, [1.0])
    with pytest.raises(TypeError, match="fp32 or bf16"):
        threefry_normal.normal_axpy([x.double(), x], kd, [1.0, 1.0])
    with pytest.raises(ValueError, match="several devices"):
        threefry_normal.normal_axpy([x, torch.zeros(6, device="meta")], kd, [1.0, 1.0])
    with pytest.raises(ValueError, match="equal slices"):
        threefry_normal._scale_entry(torch.ones(4), x)
    assert threefry_normal.normal_axpy([], kd[:0], []) == []
