"""The compression plane's plain versions (K5-K8) against the JAX
package: the quantizers and the nibble pack and unpack against the
Pallas kernels in interpret mode, bit for bit, one client row at a time;
the top-k scatter-add against the JAX plain version (its Pallas kernel
does not run in interpret mode under jax 0.9, F2b). The wrappers take
the plain versions here because the tensors lie on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import wire_pack as jwp
from repro_torch.kernels import ref, wire_pack

SIZES = (1, 2, 65, 513, 4097)
K = 2
SCATTER_RTOL = 1e-6  # fp32 sums of at most K values; the same order is expected (bitwise)


def _rows(n: int, seed: int):
    """(K, n) fp32 deltas with exact zeros, values on the code grid and
    values past the scale (clamped), and the shared scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, n)).astype(np.float32)
    x[:, ::7] = 0.0
    scale = np.float32(np.abs(x).max() / 7.0 * 0.8) if n > 1 else np.float32(0.3)
    x[:, 3::11] = np.round(x[:, 3::11] / scale) * scale  # on the grid (or next to it)
    return x, scale


def _keys(seed: int):
    rng = np.random.default_rng(seed + 100)
    return rng.integers(0, 2**32, size=(K, 2), dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", (8, 4))
def test_keyed_quantize_is_the_pallas_kernel_bitwise(n, bits):
    x, scale = _rows(n, n + bits)
    kd = _keys(n)
    tkd = _t(kd.astype(np.int64))
    codes = wire_pack.quantize_with_scale_keyed(_t(x), torch.tensor(scale), tkd, bits)
    packed = wire_pack.quantize_pack_keyed(_t(x), torch.tensor(scale), tkd, bits)
    assert codes.dtype == packed.dtype == torch.int8
    for k in range(K):
        want = np.asarray(jwp.quantize_with_scale_keyed_pallas(
            jnp.asarray(x[k]), jnp.float32(scale), jnp.asarray(kd[k]), bits, interpret=True))
        np.testing.assert_array_equal(codes[k].numpy(), want)
        if bits == 4:
            want = np.asarray(jwp.quantize_pack4_keyed_pallas(
                jnp.asarray(x[k]), jnp.float32(scale), jnp.asarray(kd[k]), interpret=True))
        np.testing.assert_array_equal(packed[k].numpy(), want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("rounding", ("streamed", "nearest"))
def test_streamed_and_nearest_quantize_are_the_pallas_kernels_bitwise(n, rounding):
    x, scale = _rows(n, n)
    u = None
    if rounding == "streamed":
        u = np.random.default_rng(n + 1).random((K, n), dtype=np.float32)
    tu = None if u is None else _t(u)
    codes8 = wire_pack.quantize_with_scale(_t(x), torch.tensor(scale), tu, 8)
    packed4 = wire_pack.quantize_pack(_t(x), torch.tensor(scale), tu, 4)
    assert torch.equal(wire_pack.quantize_pack(_t(x), torch.tensor(scale), tu, 8), codes8)
    for k in range(K):
        uk = None if u is None else jnp.asarray(u[k])
        want8 = jwp.quantize_with_scale_pallas(jnp.asarray(x[k]), jnp.float32(scale), uk, 8,
                                               interpret=True)
        want4 = jwp.quantize_pack4_pallas(jnp.asarray(x[k]), jnp.float32(scale), uk,
                                          interpret=True)
        np.testing.assert_array_equal(codes8[k].numpy(), np.asarray(want8))
        np.testing.assert_array_equal(packed4[k].numpy(), np.asarray(want4))


def test_nearest_rounds_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 7.4, 9.0]])
    codes = wire_pack.quantize_with_scale(x, torch.tensor(1.0), None, 4)
    assert codes.tolist() == [[0, 2, 2, 0, -2, -2, 7, 7]]


@pytest.mark.parametrize("n", SIZES)
def test_nibble_pack_and_unpack_are_the_pallas_kernels_bitwise(n):
    codes = np.random.default_rng(n).integers(-8, 8, size=(K, n)).astype(np.int8)
    packed = wire_pack.nibble_pack(_t(codes))
    assert packed.shape == (K, (n + 1) // 2)
    for k in range(K):
        want = np.asarray(jwp.nibble_pack_pallas(jnp.asarray(codes[k]), interpret=True))
        np.testing.assert_array_equal(packed[k].numpy(), want)
        back = np.asarray(jwp.nibble_unpack_pallas(jnp.asarray(want), n, interpret=True))
        np.testing.assert_array_equal(back, codes[k])
    assert torch.equal(wire_pack.nibble_unpack(packed, n), _t(codes))


def _payload(n: int, k: int, seed: int):
    """K clients' top-k payloads with distinct indices in each row and
    many indices shared across rows."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(n, size=min(n, 2 * k), replace=False)
    idx = np.stack([rng.choice(pool, size=k, replace=False) for _ in range(K + 1)])
    vals = rng.standard_normal((K + 1, k)).astype(np.float32)
    weights = rng.integers(1, 9, size=K + 1).astype(np.float32)
    return vals, idx.astype(np.int32), weights


@pytest.mark.parametrize("n,k", [(1, 1), (65, 9), (513, 100), (4097, 400), (9000, 3000)])
def test_topk_scatter_add_is_the_jax_plain_version(n, k):
    vals, idx, weights = _payload(n, k, n)
    got = wire_pack.topk_scatter_add(_t(vals), _t(idx), _t(weights), n).numpy()
    want = np.asarray(jref.topk_scatter_add_ref(jnp.asarray(vals), jnp.asarray(idx),
                                                jnp.asarray(weights), n))
    np.testing.assert_allclose(got, want, rtol=SCATTER_RTOL, atol=0)


def test_scatter_add_segments_hold_every_entry_once_in_client_order():
    """The kernel's inputs (the wrapper builds them the same way on the
    card): a walk over each segment's slice, summing each run of equal
    indices from 0 as the kernel does, gives the plain version's bits."""
    n, k = 9000, 3000
    vals, idx, weights = _payload(n, k, 1)
    sv, si, bounds = wire_pack.scatter_add_segments(_t(vals), _t(idx), _t(weights), n)
    assert si.dtype == bounds.dtype == torch.int32
    nseg = -(-n // wire_pack.SEGMENT)
    assert bounds.shape == (nseg + 1,) and int(bounds[0]) == 0 and int(bounds[-1]) == si.numel()
    out = np.zeros(n, np.float32)
    sv, si, bounds = sv.numpy(), si.numpy(), bounds.numpy()
    for s in range(nseg):
        for j in range(bounds[s], bounds[s + 1]):
            assert s * wire_pack.SEGMENT <= si[j] < (s + 1) * wire_pack.SEGMENT
            if j > bounds[s] and si[j - 1] == si[j]:
                continue
            acc, q = np.float32(0.0), j
            while q < bounds[s + 1] and si[q] == si[j]:
                acc = np.float32(acc + sv[q])
                q += 1
            out[si[j]] = acc
    want = ref.topk_scatter_add_ref(_t(vals), _t(idx), _t(weights), n).numpy()
    np.testing.assert_array_equal(out, want)
    assert (np.diff(si) >= 0).all()


def test_wrappers_refuse_mixed_devices_and_bad_bits():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="int4 or int8"):
        wire_pack.quantize_with_scale(x, torch.tensor(1.0), None, 3)
    with pytest.raises(ValueError, match="devices"):
        wire_pack.quantize_with_scale(x, torch.tensor(1.0), torch.zeros(2, 4, device="meta"), 8)
