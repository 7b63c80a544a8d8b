"""Nothing the harness or the reference imports is JAX or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "dynamicfusion_body_tpu"}
PORT = "dynamicfusion_body_tpu_torch"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        assert not (_imports(p) & JAX_SIDE), p


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        names = _imports(p)
        assert PORT not in names and "h100bench" not in names, p
        rel = [n.module or "" for n in ast.walk(ast.parse(p.read_text()))
               if isinstance(n, ast.ImportFrom) and n.level > 1]
        assert not rel, (p, rel)


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from h100bench.run import run_cell, banned_modules\n"
        "from h100bench.tests._small import small_cell\n"
        "for name in ('track_256_still', 'ingest_512_tsdf'):\n"
        "    run_cell(small_cell(name), 5, 0.5, False, torch.device('cpu'))\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'dynamicfusion_body_tpu_torch' in mods\n"
        "print('BANNED', banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BANNED []" in out.stdout
