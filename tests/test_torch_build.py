"""The port's kernel build cache: a library's file name hashes its source, the
shared headers of `csrc/` and the nvcc flags, so an edited header is never
served from a stale binary. CPU only: nothing is compiled here."""

import shutil

import pytest

from sam2_opt_tpu_torch.kernels import _build

LIBRARIES = ["flash_attention", "flash_attention_bwd", "fused_mlp", "window_attention"]


def test_every_source_is_a_library():
    assert _build.kernel_names() == LIBRARIES
    assert "hopper.cuh" in [p.name for p in _build.CSRC.glob("*.cuh")]


@pytest.mark.parametrize("name", LIBRARIES)
def test_library_path_covers_source_and_headers(name, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    base = _build.library_path(name)
    assert base == _build.library_path(name)  # stable
    assert base.parent == _build.BUILD_DIR and base.name.startswith(f"lib{name}-")

    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited_header = _build.library_path(name)
    assert edited_header != base

    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    edited_src = _build.library_path(name)
    assert edited_src not in (base, edited_header)

    # a new header changes the hash too
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(name) not in (base, edited_header, edited_src)
