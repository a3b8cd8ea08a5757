"""The port's own rules: ``repro_torch``, ``chip_smoke.py`` and
``chip_variants.py`` import neither JAX nor the JAX package (nor the
reference's ``benchmarks`` and ``examples``, whose setup the port keeps
its own copy of), and the smoke script refuses to run without a CUDA
card."""
from __future__ import annotations

import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
VARIANTS = ROOT / "chip_variants.py"
BANNED = ("jax", "jaxlib", "repro", "benchmarks", "examples")


def _modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages([str(PKG)], prefix="repro_torch."):
        names.append(info.name)
    return sorted(names)


def _banned_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        hits += [f"{path.name}:{node.lineno} {r}" for r in roots
                 if r in BANNED]
    return hits


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = _modules()
    assert len(mods) > 30
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in BANNED)
        + f"import importlib\nMODS = {mods!r}\n"
        + "for m in MODS:\n"
        + "    importlib.import_module(m)\n"
        + "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        + f"{BANNED!r} and sys.modules[m] is not None)\n"
        + "assert not leaked, leaked\n"
        + "print('imported', len(MODS))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"imported {len(mods)}" in out.stdout


def test_training_and_checkpoint_modules_are_walked():
    mods = _modules()
    for name in ("repro_torch.training.adamw", "repro_torch.training.train",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint.store",
                 "repro_torch.launch.train"):
        assert name in mods


def test_example_modules_are_walked():
    mods = _modules()
    for name in ("paper_setup", "serverless_sim", "quickstart",
                 "serve_multilora", "serve_continuous", "train_lora"):
        assert f"repro_torch.examples.{name}" in mods


@pytest.mark.parametrize("path",
                         sorted(PKG.rglob("*.py")) + [SMOKE, VARIANTS],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    assert _banned_imports(path) == []


def test_scan_catches_a_reference_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom repro.models import layers\n"
                   "import jax.numpy as jnp\nfrom repro_torch import x\n"
                   "from benchmarks.common import paper_workload\n")
    assert _banned_imports(bad) == ["bad.py:2 repro", "bad.py:3 jax",
                                    "bad.py:5 benchmarks"]


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    out =subprocess.run([sys.executable, str(SMOKE)], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a CUDA card" in out.stderr
