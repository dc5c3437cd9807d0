"""The normal kernel and K7 (nibble pack, nibble unpack, dequantize) on a
CUDA card against their plain versions, bit for bit, at their run edges
(``threefry_normal.RUN_EDGES``, ``wire_pack.K7_RUN_EDGES``). A CUDA kernel
has no interpret mode: without a card these tests skip. They take the
cases chip_smoke.py does not: at each normal edge the other dtype and
another kind of scale than its ``normal_edges``, and K7 at K = 2 (chip_smoke
takes K = 3 and 4).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card_kernels.py
"""

import pytest
import torch

from repro_torch.core import keys
from repro_torch.kernels import ref, threefry_normal, wire_pack

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and run only there")
    return torch.device("cuda")


def _scale(kind: str, device):
    if kind == "value":
        return 0.01
    if kind == "device":
        return torch.tensor(0.02, device=device)
    return torch.tensor([0.5, 0.0, -1.5, 0.01], device=device)


@pytest.mark.parametrize("i", range(len(threefry_normal.RUN_EDGES)))
def test_normal_axpy_is_its_plain_version_on_the_card(card, i):
    numel = threefry_normal.RUN_EDGES[i]
    kinds = ("device", "slices", "value") if numel % 4 == 0 else ("device", "value")
    dname, kind = ("bfloat16", "float32")[i % 2], kinds[i % len(kinds)]
    gen = torch.Generator(device=card).manual_seed(numel)
    x = torch.randn(numel, generator=gen, device=card).to(getattr(torch, dname))
    kd = keys.split(keys.PRNGKey(numel), 1)
    s = _scale(kind, card)
    got = threefry_normal.normal_axpy([x], kd, [s])[0]
    assert torch.equal(got, ref.normal_axpy_ref([x], kd, [s])[0])


@pytest.mark.parametrize("n", wire_pack.K7_RUN_EDGES + (4_097,))
def test_k7_is_its_plain_version_on_the_card(card, n):
    gen = torch.Generator(device=card).manual_seed(n)
    codes = torch.randint(-8, 8, (2, n), generator=gen, device=card, dtype=torch.int8)
    packed = wire_pack.nibble_pack(codes)
    assert torch.equal(packed, ref.nibble_pack_ref(codes))
    assert torch.equal(wire_pack.nibble_unpack(packed, n), codes)
    codes8 = torch.randint(-127, 128, (2, n), generator=gen, device=card, dtype=torch.int8)
    scales = torch.rand(2, generator=gen, device=card) * 1e-3 + 1e-5
    for scale in (scales, scales[1]):
        assert torch.equal(wire_pack.dequantize(codes8, scale), ref.dequantize_ref(codes8, scale))
