"""The port and chip_smoke.py import neither JAX nor the JAX package: the
machine with the GPU has no JAX."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import importlib, pkgutil, sys
import dynamicfusion_body_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
import bench, chip_smoke  # chip_smoke's own imports, and bench's bumpy_sdf
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "dynamicfusion_body_tpu"))
assert len(mods) >= 15, mods
assert not bad, bad
print("ok")
"""


def test_port_and_smoke_import_no_jax():
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_fails_without_gpu():
    """No CUDA device here: the smoke exits nonzero and prints no result."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
