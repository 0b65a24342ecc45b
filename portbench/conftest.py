"""Test support above `tests/conftest.py`: the tiny copy of the benchmark
(`make_tiny`) sizes every traffic file by its driver, so the SAM ViT
driver's traffic gets the image driver's tiny sizes. `make_tiny` writes
every configuration as hiera-t, so its copy of the ViT cell is not run;
`tests/test_portbench_sam_vit.py` builds a tiny copy of that cell of its
own."""

from __future__ import annotations

import pytest


@pytest.fixture(scope="session", autouse=True)
def _sam_image_tiny_sizes():
    from conftest import TINY_SIZES

    TINY_SIZES.setdefault("sam_image", TINY_SIZES["image"])
