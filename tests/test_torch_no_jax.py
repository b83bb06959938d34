"""The port stands alone: no JAX and nothing of the JAX package."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "benchmarks_torch").glob("*.py"))
              + [ROOT / "chip_smoke.py",
                 ROOT / "examples" / "serve_heterogeneous_torch.py",
                 ROOT / "examples" / "quickstart_torch.py",
                 ROOT / "examples" / "train_lm_torch.py"])
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s)"
    r"|.*import_module\(\s*['\"](jax|repro)[.'\"])", re.M)


def _modules():
    pkg = ROOT / "src"
    return sorted(".".join(p.relative_to(pkg).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (pkg / "repro_torch").rglob("*.py"))


def test_every_port_module_imports_with_jax_blocked():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "for name in sys.argv[1:]:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    mods = _modules()
    assert "repro_torch.serving.paged_lm" in mods
    assert "repro_torch.kernels.flash_attention.ops" in mods
    assert "repro_torch.core.simulator" in mods
    for name in ("validate", "faults", "telemetry"):
        assert f"repro_torch.core.{name}" in mods
    for name in ("data.pipeline", "optim.adamw", "train.steps",
                 "train.trainer", "checkpoint.checkpointer", "launch.train",
                 "tree", "models.moe", "models.ssm", "models.hymba",
                 "models.whisper"):
        assert f"repro_torch.{name}" in mods
    r = subprocess.run([sys.executable, "-c", code, *mods], cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import_in_source(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_scan_catches_forbidden_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import nn",
                 "from repro.serving import engine", "import repro.configs",
                 "  from repro import x",
                 "importlib.import_module('repro.configs.x')"):
        assert FORBIDDEN.search(line), line
    for line in ("from repro_torch.serving import engine",
                 "import repro_torch", "x = 'jax'"):
        assert not FORBIDDEN.search(line), line
