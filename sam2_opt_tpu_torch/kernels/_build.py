"""Build and load the port's CUDA kernels, and register their wrappers as
operators.

Each `csrc/<name>.cu` has a plain C interface and is compiled with `nvcc` for
Hopper (`sm_90a`) into a shared library under `<repo>/build/`, on first use,
then loaded with `ctypes`. PyTorch's headers are never included, so a build
takes seconds. The library's file name carries a hash of its source, of every
header in `csrc/` (the sources share `hopper.cuh`) and of the flags, so an
edited source or header is rebuilt and never mixed with a stale binary.

Every launch wrapper is an operator of the `sam2_opt_tpu_torch` namespace
(`operator`), so `torch.export` traces a kernel call as one graph node and
an exported program launches the kernel through the same wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sam2_opt_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
NAMESPACE = "sam2_opt_tpu_torch"


def operator(name: str, schema: str):
    """Decorator: the function becomes the CPU implementation of the
    operator `sam2_opt_tpu_torch::<name>` (`torch.library.custom_op`), the
    kernel's plain version. The kernel module registers the CUDA
    implementation (the launch, counted there), the fake (the CUDA outputs'
    shapes and strides, for tracing) and, where the kernel has one, the
    backward. No other device has an implementation."""
    return torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=(), device_types="cpu",
                                   schema=schema)


def kernel_names():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every missing library at once, one nvcc process per source,
    all started together. Returns {name: compiler log}; raises if any build
    fails (after every started process has ended)."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    logs, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        logs[name] = f"[{time.perf_counter() - t0:.1f} s]\n{log}"
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
