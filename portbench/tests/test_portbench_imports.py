"""Nothing that runs on the card loads JAX or the JAX package: no module
that `portbench/run.py` can load (the harness and the port) imports a
top-level `jax`, `jaxlib`, `flax` or `sam2_opt_tpu`, compared whole (the
port's name begins with the JAX package's), and the reference imports
nothing of the port. A run refuses to print a result without a card, or
where the port is absent, or where a forbidden module is loaded."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "sam2_opt_tpu"}


def _top_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(*dirs):
    for d in dirs:
        for p in sorted((REPO / d).rglob("*.py")):
            if "tests" not in p.relative_to(REPO).parts:
                yield p


def test_no_jax_in_what_the_run_loads():
    bad = {str(p.relative_to(REPO)): sorted(set(_top_imports(p)) & FORBIDDEN)
           for p in _sources("portbench", "sam2_opt_tpu_torch")}
    assert {k: v for k, v in bad.items() if v} == {}


def test_reference_imports_nothing_of_the_port():
    bad = {str(p.relative_to(REPO)): sorted(set(_top_imports(p)) & (FORBIDDEN
                                                                    | {"sam2_opt_tpu_torch"}))
           for p in _sources("portbench/reference")}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_check_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "sam2_opt_tpu_torch_lookalike", types.ModuleType("x"))
    assert "sam2_opt_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sam2_opt_tpu.models", types.ModuleType("x"))
    assert "sam2_opt_tpu" in run.forbidden_modules()


def test_forbidden_module_refuses_the_result(tiny_root, monkeypatch, capsys):
    from conftest import run_cell

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    rc, line = run_cell(tiny_root, "hiera_large.image_3prompt", capsys=capsys)
    assert rc == 4 and line is None


def test_a_tiny_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh process ends with a result: nothing it
    loaded is forbidden."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2]);"
            "from pathlib import Path; from portbench import run;"
            "rc = run.main(['--workload', 'hiera_large.image_3prompt', '--seed', '5',"
            " '--seconds', '0.5'], root=Path(sys.argv[3]), bench=Path(sys.argv[3]) / 'portbench',"
            " device='cpu'); print('modules', sorted(set(m.split('.')[0] for m in sys.modules)"
            " & {'jax', 'jaxlib', 'flax', 'sam2_opt_tpu'})); sys.exit(rc)")
    out = subprocess.run([sys.executable, "-c", code, str(REPO), str(REPO / "portbench/tests"),
                          str(tiny_root)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2])["attempted"] >= 1 and lines[-1] == "modules []"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "hiera_large.video_1obj", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    fails before printing anything."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from pathlib import Path;"
            "from portbench import run; sys.exit(run.main(['--workload',"
            " 'hiera_large.image_3prompt', '--seed', '1', '--seconds', '1'],"
            " root=Path(sys.argv[1]), device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
