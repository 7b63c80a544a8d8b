"""The port's marching-cubes table generator
(``dynamicfusion_body_tpu_torch/tools/gen_mc_tables.py``) against both
table sets: the port's ``ops/mc_tables.py`` and what the JAX generator
(``tools/gen_mc_tables.py``) builds case by case. The JAX generator's
``main`` writes into the JAX package, so it is not called: its
``build_case`` is run over the 256 cases as its ``main`` does."""

import filecmp
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

from dynamicfusion_body_tpu.ops import mc_tables as jax_tables
from dynamicfusion_body_tpu_torch.ops import mc_tables as port_tables
from dynamicfusion_body_tpu_torch.tools import gen_mc_tables

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("TRI_TABLE", "TRI_COUNT", "EDGE_BASE", "EDGE_AXIS")


@pytest.fixture(scope="module")
def generated():
    return gen_mc_tables.build_tables()


@pytest.fixture(scope="module")
def jax_generated():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_mc_tables", ROOT / "tools" / "gen_mc_tables.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    tri_table = np.full((256, 5, 3), -1, dtype=np.int32)
    tri_count = np.zeros(256, dtype=np.int32)
    for case in range(256):
        tris = gen.build_case(case)
        tri_count[case] = len(tris)
        for i, t in enumerate(tris):
            tri_table[case, i] = t
    return dict(TRI_TABLE=tri_table, TRI_COUNT=tri_count,
                EDGE_BASE=np.array([b for b, _ in gen.EDGES], np.int32),
                EDGE_AXIS=np.array([a for _, a in gen.EDGES], np.int32))


@pytest.mark.parametrize("name", NAMES)
def test_tables_equal_both_sets(generated, jax_generated, name):
    got = generated[name]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, getattr(port_tables, name))
    np.testing.assert_array_equal(got, jax_generated[name])
    np.testing.assert_array_equal(got, getattr(jax_tables, name))


def test_tables_from_first_principles(generated):
    """Each case's triangle count matches its padding, a single inside
    corner gives one triangle, and every emitted edge crosses the
    surface."""
    tri, cnt = generated["TRI_TABLE"], generated["TRI_COUNT"]
    base, axis = generated["EDGE_BASE"], generated["EDGE_AXIS"]
    assert cnt[0] == cnt[255] == 0 and cnt.max() == 5
    assert all(cnt[1 << b] == 1 for b in range(8))
    for case in range(256):
        n = cnt[case]
        assert np.all(tri[case, :n] >= 0) and np.all(tri[case, n:] == -1)
        inside = [(case >> b) & 1 for b in range(8)]
        for e in tri[case, :n].reshape(-1):
            b = base[e]
            assert inside[b] != inside[b | (1 << axis[e])]


def test_main_writes_the_module_elsewhere(tmp_path, capsys):
    """--out defaults to a temporary path; the written module is the
    package's ops/mc_tables.py byte for byte."""
    out = gen_mc_tables.main([])
    assert Path(out).resolve().parent != (
        ROOT / "dynamicfusion_body_tpu_torch" / "ops")
    assert filecmp.cmp(out, port_tables.__file__, shallow=False)
    shutil.rmtree(Path(out).parent)
    mine = tmp_path / "t.py"
    assert gen_mc_tables.main(["--out", str(mine)]) == str(mine)
    assert filecmp.cmp(mine, port_tables.__file__, shallow=False)
    assert "max tris in a case: 5" in capsys.readouterr().out
