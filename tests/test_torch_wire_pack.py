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


def _scatter_add_windows(vals, idx, weights, n):
    """K8 as the card computes it, written out over the plain layout: one
    window at a time, the clients in client order, each client's run of
    the window from every chunk; each entry adds weight * value (float32
    product, then float32 sum) into a window that starts at +0.0."""
    starts, slots = (t.numpy() for t in wire_pack.unpack_layout(_t(idx), n))
    K_ = idx.shape[0]
    nseg, chunk = -(-n // wire_pack.SEGMENT), wire_pack.UNPACK_CHUNK
    out = np.zeros(n, np.float32)
    for s in range(nseg):
        lo = s * wire_pack.SEGMENT
        window = np.zeros(min(wire_pack.SEGMENT, n - lo), np.float32)
        for r in range(K_):
            for b in range(starts.shape[1]):
                for j in slots[r, b * chunk + starts[r, b, s]:b * chunk + starts[r, b, s + 1]]:
                    at = idx[r, j] - lo
                    window[at] = np.float32(window[at] + np.float32(weights[r] * vals[r, j]))
        out[lo:lo + window.size] = window
    return out


SCATTER_CASES = ["shared indices", "out of range", "negative and zero weights",
                 "-0.0 values", "several chunks", "window groups"]


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_add_windows_hold_every_entry_once_in_client_order(case, monkeypatch):
    """The window-by-client walk over the layout (K8's sum kernel, plain)
    gives the plain version's bits: indices repeated across clients and
    summed in client order from 0, indices out of range dropped, negative
    and zero weights, -0.0 values (0.0 + -0.0 is +0.0), rows of several
    chunks, and a row sorted by window groups."""
    n, k = 9000, 600
    if case == "several chunks":
        n, k = 60_000, 2 * wire_pack.UNPACK_CHUNK + 700
    vals, idx, weights = _payload(n, k, len(case))
    if case == "out of range":
        idx[:, ::13] = -1
        idx[1, 5::17] = n
        idx[2, 3] = 2**31 - 1
    elif case == "negative and zero weights":
        weights = np.array([-2.5, 0.0, 3.0], np.float32)
    elif case == "-0.0 values":
        vals[:, ::3] = -0.0
        weights = np.array([1.0, -0.0, 2.0], np.float32)
    elif case == "window groups":  # the layout by groups of 2 windows past 2 windows
        monkeypatch.setattr(wire_pack, "UNPACK_MAX_WINDOWS", 2)
        monkeypatch.setattr(wire_pack, "UNPACK_GROUP_WINDOWS", 2)
    want = ref.topk_scatter_add_ref(_t(vals), _t(idx), _t(weights), n).numpy()
    got = _scatter_add_windows(vals, idx, weights, n)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    dense = wire_pack.topk_scatter_add(_t(vals), _t(idx), _t(weights), n).numpy()
    np.testing.assert_array_equal(dense.view(np.uint32), want.view(np.uint32))
    if case == "-0.0 values":
        assert (np.signbit(want) == (want < 0)).all()  # no -0.0 comes out


def test_wrappers_refuse_mixed_devices_and_bad_bits():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="int4 or int8"):
        wire_pack.quantize_with_scale(x, torch.tensor(1.0), None, 3)
    with pytest.raises(ValueError, match="devices"):
        wire_pack.quantize_with_scale(x, torch.tensor(1.0), torch.zeros(2, 4, device="meta"), 8)


def _client_scales(x):
    """One scale a client: each row's absmax over 7, a row of zeros at 1."""
    s = np.abs(x).max(axis=1) / np.float32(7.0)
    return np.where(s > 0, s, np.float32(1.0)).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", (8, 4))
def test_per_client_scales_are_the_pallas_kernels_bitwise(n, bits):
    """The slow path quantizes each client against its own scale: the
    wrappers take (K,) scales, and row k equals the Pallas kernel with
    scale k, keyed, streamed and nearest."""
    x, _ = _rows(n, 3 * n + bits)
    x[1] *= 3.0
    scale = _client_scales(x)
    kd = _keys(n + 1)
    u = np.random.default_rng(n + 2).random((K, n), dtype=np.float32)
    ts, tkd = _t(scale), _t(kd.astype(np.int64))
    keyed = wire_pack.quantize_with_scale_keyed(_t(x), ts, tkd, bits)
    keyed_packed = wire_pack.quantize_pack_keyed(_t(x), ts, tkd, bits)
    streamed = wire_pack.quantize_with_scale(_t(x), ts, _t(u), bits)
    nearest_packed = wire_pack.quantize_pack(_t(x), ts, None, bits)
    for k in range(K):
        xk, sk = jnp.asarray(x[k]), jnp.float32(scale[k])
        want = jwp.quantize_with_scale_keyed_pallas(xk, sk, jnp.asarray(kd[k]), bits,
                                                    interpret=True)
        np.testing.assert_array_equal(keyed[k].numpy(), np.asarray(want))
        if bits == 4:
            want = jwp.quantize_pack4_keyed_pallas(xk, sk, jnp.asarray(kd[k]), interpret=True)
        np.testing.assert_array_equal(keyed_packed[k].numpy(), np.asarray(want))
        want = jwp.quantize_with_scale_pallas(xk, sk, jnp.asarray(u[k]), bits, interpret=True)
        np.testing.assert_array_equal(streamed[k].numpy(), np.asarray(want))
        want = (jwp.quantize_pack4_pallas(xk, sk, None, interpret=True) if bits == 4 else
                jwp.quantize_with_scale_pallas(xk, sk, None, bits, interpret=True))
        np.testing.assert_array_equal(nearest_packed[k].numpy(), np.asarray(want))


# K5's packing edges: the odd n's last block (its second word unused), n
# of 1 to 3, one n of each residue mod 4 (when half = (n+1)//2 is odd, a
# high-half byte spans two threefry blocks), and a few blocks of threads
EDGE_SIZES = (1, 2, 3, 4, 5, 6, 7, 65, 513)


@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("scales", ("shared", "per-client"))
def test_keyed_quantize_at_packing_edges_is_the_jax_reference_bitwise(n, bits, scales):
    """Codes and wire buffers against JAX's plain oracles (the streamed
    threefry uniform, then quantize and pack), row by row; the Pallas
    kernels equal those oracles (test_keyed_quantize_is_the_pallas_kernel_
    bitwise holds the port to them at SIZES)."""
    x, scale = _rows(n, 5 * n + bits)
    if scales == "per-client":
        x[1] *= 3.0
        scale = _client_scales(x)
    kd = _keys(2 * n + 7)
    ts, tkd = _t(np.asarray(scale)), _t(kd.astype(np.int64))
    codes = wire_pack.quantize_with_scale_keyed(_t(x), ts, tkd, bits)
    packed = wire_pack.quantize_pack_keyed(_t(x), ts, tkd, bits)
    assert packed.shape == (K, (n + 1) // 2 if bits == 4 else n)
    for k in range(K):
        sk = jnp.float32(scale[k] if scales == "per-client" else scale)
        u = jref.threefry_uniform_ref(jnp.asarray(kd[k]), n)
        want = jref.quantize_codes_with_scale_ref(jnp.asarray(x[k]), sk, u, 2.0 ** (bits - 1) - 1)
        np.testing.assert_array_equal(codes[k].numpy(), np.asarray(want))
        want = jref.quantize_pack_ref(jnp.asarray(x[k]), sk, u, bits)
        np.testing.assert_array_equal(packed[k].numpy(), np.asarray(want))


def test_a_scale_of_the_wrong_length_is_refused():
    x = torch.ones(3, 5)
    with pytest.raises(ValueError, match="3 clients"):
        wire_pack._scale_tensor(torch.ones(2), 3, x)
    assert wire_pack._scale_tensor(torch.tensor([2.0]), 3, x)[1] == 0
    assert wire_pack._scale_tensor(torch.ones(3), 3, x)[1] == 1


@pytest.mark.parametrize("n", SIZES)
def test_dequantize_is_the_pallas_kernel_bitwise(n):
    codes = np.random.default_rng(n).integers(-127, 128, size=(K, n)).astype(np.int8)
    scale = np.array([3.7e-4, 1.0 / 7.0][:K], np.float32)
    got = wire_pack.dequantize(_t(codes), _t(scale))
    shared = wire_pack.dequantize(_t(codes), torch.tensor(scale[0]))
    assert got.dtype == torch.float32 and got.shape == (K, n)
    for k in range(K):
        want = np.asarray(jwp.dequantize_pallas(jnp.asarray(codes[k]), jnp.float32(scale[k]),
                                                interpret=True))
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32), want.view(np.uint32))
        want = np.asarray(jref.dequantize_ref(jnp.asarray(codes[k]), jnp.float32(scale[0])))
        np.testing.assert_array_equal(shared[k].numpy().view(np.uint32), want.view(np.uint32))


# K7's run edges (wire_pack.K7_RUN_EDGES): at K = 3 an odd n starts rows 1
# and 2 off the 16-byte grid, and a flat run of an even n crosses rows
@pytest.mark.parametrize("n", wire_pack.K7_RUN_EDGES)
@pytest.mark.parametrize("clients", (2, 3))
def test_nibble_pack_and_unpack_at_run_edges_are_the_pallas_kernels_bitwise(n, clients):
    codes = np.random.default_rng(7 * n + clients).integers(-8, 8, size=(clients, n)).astype(
        np.int8)
    packed = wire_pack.nibble_pack(_t(codes))
    assert packed.shape == (clients, (n + 1) // 2)
    for k in range(clients):
        want = np.asarray(jwp.nibble_pack_pallas(jnp.asarray(codes[k]), interpret=True))
        np.testing.assert_array_equal(packed[k].numpy(), want)
        back = np.asarray(jwp.nibble_unpack_pallas(jnp.asarray(want), n, interpret=True))
        np.testing.assert_array_equal(wire_pack.nibble_unpack(packed, n)[k].numpy(), back)
    assert torch.equal(wire_pack.nibble_unpack(packed, n), _t(codes))


@pytest.mark.parametrize("n", wire_pack.K7_RUN_EDGES)
@pytest.mark.parametrize("clients", (2, 3))
@pytest.mark.parametrize("scales", ("shared", "per-client"))
def test_dequantize_at_run_edges_is_the_pallas_kernel_bitwise(n, clients, scales):
    rng = np.random.default_rng(11 * n + clients)
    codes = rng.integers(-127, 128, size=(clients, n)).astype(np.int8)
    scale = (rng.random(clients, dtype=np.float32) * np.float32(1e-3)
             + np.float32(1e-5)).astype(np.float32)
    got = wire_pack.dequantize(_t(codes), _t(scale) if scales == "per-client"
                               else torch.tensor(scale[0]))
    assert got.dtype == torch.float32 and got.shape == (clients, n)
    for k in range(clients):
        sk = scale[k] if scales == "per-client" else scale[0]
        want = np.asarray(jwp.dequantize_pallas(jnp.asarray(codes[k]), jnp.float32(sk),
                                                interpret=True))
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32), want.view(np.uint32))


def _last_wins(vals, idx, n):
    """The TPU kernels' serial loop: pairs stored in payload order (an
    index outside [0, n) is dropped, as the port's plain version does)."""
    out = np.zeros((vals.shape[0], n), np.float32)
    for k in range(vals.shape[0]):
        for j in range(vals.shape[1]):
            if 0 <= idx[k, j] < n:
                out[k, idx[k, j]] = vals[k, j]
    return out


@pytest.mark.parametrize("n,k", [(1, 1), (65, 9), (513, 100), (4097, 400), (9000, 3000)])
def test_topk_unpack_is_the_jax_plain_version_on_distinct_indices(n, k):
    vals, idx, _ = _payload(n, k, n + 5)
    got = wire_pack.topk_unpack(_t(vals[:K]), _t(idx[:K]), n)
    assert got.dtype == torch.float32 and got.shape == (K, n)
    for r in range(K):
        want = np.asarray(jref.topk_unpack_ref(jnp.asarray(vals[r]), jnp.asarray(idx[r]), n))
        np.testing.assert_array_equal(got[r].numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n,k", [(1, 3), (65, 40), (4097, 5000), (9000, 6000)])
def test_topk_unpack_keeps_the_last_pair_of_a_duplicate_index(n, k):
    """Duplicates in a row (more pairs than n, or drawn with replacement):
    the last in payload order wins, as the serial TPU kernel stores them."""
    rng = np.random.default_rng(n)
    idx = rng.integers(0, n, size=(K, k)).astype(np.int32)
    idx[:, -1] = idx[:, 0]  # the first and the last pair name one index
    vals = rng.standard_normal((K, k)).astype(np.float32)
    got = wire_pack.topk_unpack(_t(vals), _t(idx), n).numpy()
    np.testing.assert_array_equal(got, _last_wins(vals, idx, n))
    assert (np.unique(idx[0]).size < k) and got[0, idx[0, 0]] == vals[0, -1]


def _walk_layout(vals, idx, n):
    """K9's window kernel over the plain layout: each window gathers its
    run from every chunk, and the largest payload position j that names
    an element wins it. Checks the layout on the way: each chunk's starts,
    counts and window order."""
    starts, slots = (t.numpy() for t in wire_pack.unpack_layout(_t(idx), n))
    K_, k = idx.shape
    nseg, seg_w, chunk = -(-n // wire_pack.SEGMENT), wire_pack.SEGMENT, wire_pack.UNPACK_CHUNK
    nchunk = -(-k // chunk)
    assert starts.shape == (K_, nchunk, nseg + 1) and starts.dtype == slots.dtype == np.int32
    out = np.zeros((K_, n), np.float32)
    for r in range(K_):
        for b in range(nchunk):
            part = idx[r, b * chunk:(b + 1) * chunk]
            assert starts[r, b, 0] == 0 and starts[r, b, -1] == ((part >= 0) & (part < n)).sum()
            assert (np.diff(starts[r, b]) >= 0).all()
            assert (slots[r, b * chunk + starts[r, b, -1]:(b + 1) * chunk] == -1).all()
        for s in range(nseg):
            winner = {}
            for b in range(nchunk):
                js = slots[r, b * chunk + starts[r, b, s]:b * chunk + starts[r, b, s + 1]]
                assert (np.diff(js) > 0).all()  # payload order inside a window
                assert ((js >= b * chunk) & (js < (b + 1) * chunk)).all()
                assert ((idx[r, js] >= s * seg_w) & (idx[r, js] < (s + 1) * seg_w)).all()
                for j in js:
                    winner[idx[r, j]] = max(winner.get(idx[r, j], -1), j)
            for at, j in winner.items():
                out[r, at] = vals[r, j]
    return out


def test_unpack_layout_gives_each_row_its_windows():
    """K9's layout, plain (the kernels build it on the card, their order
    inside a window aside): every entry in range in its chunk's run of its
    window once, and the largest-j walk of it gives the serial loop's
    result. Three chunks a row, the last one short."""
    n, k = 9000, 2 * wire_pack.UNPACK_CHUNK + 1000
    rng = np.random.default_rng(2)
    idx = rng.integers(-50, n + 50, size=(K, k)).astype(np.int32)
    vals = rng.standard_normal((K, k)).astype(np.float32)
    want = _last_wins(vals, idx, n)
    np.testing.assert_array_equal(_walk_layout(vals, idx, n), want)
    np.testing.assert_array_equal(wire_pack.topk_unpack(_t(vals), _t(idx), n).numpy(), want)


@pytest.mark.parametrize("max_windows,group_windows", [(1, 1), (2, 2), (3, 2), (4, 3)])
def test_unpack_layout_by_window_groups_is_one_histograms(max_windows, group_windows,
                                                          monkeypatch):
    """Past ``UNPACK_MAX_WINDOWS`` windows a row is sorted one group of
    ``UNPACK_GROUP_WINDOWS`` windows at a time, each group's run after the
    groups' before: the layout of one histogram of the row, bit for bit,
    and its walk the serial loop's."""
    n, k = 9000, 2 * wire_pack.UNPACK_CHUNK + 1000
    rng = np.random.default_rng(max_windows)
    idx = rng.integers(-50, n + 50, size=(K, k)).astype(np.int32)
    idx[:, ::7] = rng.choice([2047, 2048, 4095, 4096, 6143, 6144], size=idx[:, ::7].shape)
    vals = rng.standard_normal((K, k)).astype(np.float32)
    assert wire_pack.UNPACK_GROUP_WINDOWS <= wire_pack.UNPACK_MAX_WINDOWS
    one = wire_pack.unpack_layout(_t(idx), n)
    monkeypatch.setattr(wire_pack, "UNPACK_MAX_WINDOWS", max_windows)
    monkeypatch.setattr(wire_pack, "UNPACK_GROUP_WINDOWS", group_windows)
    grouped = wire_pack.unpack_layout(_t(idx), n)
    for a, b in zip(one, grouped):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(_walk_layout(vals, idx, n), _last_wins(vals, idx, n))


def _edge_case(name: str):
    """(idx (K, k) int32, n): payloads whose windows' edges matter."""
    rng = np.random.default_rng(len(name))
    if name == "duplicates across a window edge":
        n = 5000
        idx = rng.integers(0, n, size=(K, 64))
        idx[:, 1::4], idx[:, 3::4] = 2047, 2048  # both sides of the first edge, repeatedly
        idx[1, -6:] = [4095, 4096, 4095, 4096, 2047, 2048]
    elif name == "the last index of the row":
        n = 4097  # its last window is one element wide
        idx = rng.integers(0, n, size=(K, 40))
        idx[:, ::3] = n - 1
        idx[0, -1] = n - 2
    elif name == "indices out of range dropped":
        n = 3000
        idx = rng.integers(0, n, size=(K, 48))
        idx[:, :6] = [-1, n, n + 1, 2**31 - 1, -(2**31), 2 * n]
        idx[1, -3:] = [-7, n - 1, n]
    elif name == "every entry in one window":
        n = 9000
        idx = rng.integers(2048, 4096, size=(K, 3000))  # more entries than the window holds
    else:  # a row whose entries are all out of range
        n = 4097
        idx = rng.integers(0, n, size=(K, 50))
        idx[0] = rng.choice([-1, n, n + 2047, 10**6], size=50)
    return idx.astype(np.int32), n


@pytest.mark.parametrize("name", ["duplicates across a window edge", "the last index of the row",
                                  "indices out of range dropped", "every entry in one window",
                                  "a row all out of range"])
def test_topk_unpack_at_window_edges(name):
    idx, n = _edge_case(name)
    vals = np.random.default_rng(n).standard_normal(idx.shape).astype(np.float32)
    want = _last_wins(vals, idx, n)
    got = wire_pack.topk_unpack(_t(vals), _t(idx), n)
    assert got.dtype == torch.float32 and got.shape == (K, n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(_walk_layout(vals, idx, n), want)
