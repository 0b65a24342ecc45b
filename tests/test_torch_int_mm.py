"""The int8 product of `sam2_opt_tpu_torch/quant/int8.py` (`int8_matmul`,
`torch._int_mm` with the rows padded to 17) against the plain int32
product: on the CPU, and on the card (`gpu`) at the mask decoder's
token-side row counts (B x the object-score, IoU and mask tokens plus the
prompt points), at CUDA's minimum and at a frame's 4096 rows. No JAX here,
so the card runs the `gpu` cases:
`python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_int_mm.py`.
"""

import pytest
import torch

from sam2_opt_tpu_torch.quant.int8 import INT_MM_MIN_ROWS, int8_matmul

ROWS = [1, 7, 16, 17, 64, 4096]


def _operands(rows, k=256, n=128):
    gen = torch.Generator().manual_seed(rows)
    a = torch.randint(-127, 128, (rows, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    return a, w


def _plain(a, w):
    return a.int() @ w.int().t()


@pytest.mark.parametrize("rows", ROWS)
def test_int8_matmul_cpu(rows):
    a, w = _operands(rows)
    before = int8_matmul.launches
    got = int8_matmul(a, w)
    assert int8_matmul.launches == before + 1  # one product, padded or not
    assert INT_MM_MIN_ROWS == 17
    assert got.dtype == torch.int32 and got.shape == (rows, 128)
    assert torch.equal(got, _plain(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ROWS)
def test_int8_matmul_on_card(rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a, w = _operands(rows)
    got = int8_matmul(a.cuda(), w.cuda())
    assert got.is_cuda and got.dtype == torch.int32 and got.shape == (rows, 128)
    assert torch.equal(got.cpu(), _plain(a, w))
