"""The port and chip_smoke.py import neither JAX nor the JAX package, nor
the JAX side's scripts (bench.py, benchmarks/suite.py): the machine with
the GPU has no JAX, and the port keeps its own copies of what it needs
(the native I/O source, the round-5 tools, the ablation grid, the MC
table generator, the DHBC checkpoint converter and the microbenchmarks
included). Nor does
importing them import matplotlib, which that machine lacks."""

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
import chip_smoke  # and chip_smoke's own imports
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "dynamicfusion_body_tpu", "bench",
                                    "suite", "benchmarks"))
assert len(mods) >= 88, mods
new = {"benchmarks.bench512_sharded", "native", "utils.visualize",
       "tools._frames", "tools.profile_solve5", "tools.exp_freeze",
       "tools.exp_solver", "tools.profile_frame5", "tools.sweep_solver5",
       "tools.sweep_frame5", "tools.make_ablation", "tools.gen_mc_tables",
       "tools.convert_tf_dhbc", "tools.profile_mc2", "tools.profile_prims",
       "tools.profile_prims2", "tools.profile_solver", "tools.exp_asm",
       "ops.knn_grid_cuda", "tools.profile_knn_grid", "ops.rigid_update_cuda",
       "tools.profile_rigid_update", "ops.icp_pick_cuda",
       "tools.profile_icp_pick"}
missing = {m for m in new if pkg.__name__ + "." + m not in mods}
assert not missing, missing
assert "matplotlib" not in sys.modules  # imported lazily, on a call
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
