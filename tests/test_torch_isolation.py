"""The port stands alone: no module of it, and not ``chip_smoke.py``,
imports ``jax`` or the JAX package. Checked twice — by importing every
port module with both made unimportable, and by scanning the sources'
import statements."""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "multigpu_advectiondiffusion_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "multigpu_advectiondiffusion_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "multigpu_advectiondiffusion_tpu"):
    sys.modules[name] = None  # any import of these now raises
import multigpu_advectiondiffusion_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(" ".join(names))
"""

# modules every slice so far must reach (the Burgers, 2-D and mesh
# slices among them)
_EXPECTED = (
    "models.diffusion", "models.burgers", "ops.flux", "ops.weno",
    "ops.kernels.fused_diffusion", "ops.kernels.fused_burgers",
    "ops.kernels.whole_run", "ops.kernels.fused_diffusion2d",
    "ops.kernels.fused_burgers2d", "timestepping.cfl", "cli.__main__",
    "convert", "models.ensemble", "resilience.errors", "cli.drivers",
    "examples.inverse_diffusivity", "parallel", "parallel.mesh",
    "parallel.halo",
)


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 29  # every module was reached
    missing = [m for m in _EXPECTED
               if f"multigpu_advectiondiffusion_tpu_torch.{m}" not in names]
    assert not missing, missing


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_no_port_source_names_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 30
    bad = [
        f"{f.relative_to(REPO)}: {mod}"
        for f in files for mod in _imported_modules(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad
