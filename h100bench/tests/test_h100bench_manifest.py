"""BENCHMARK.json keeps to the benchmark's contract, and every cell's
configuration, traffic and metric readers resolve by name."""

import json
import re

import pytest

from h100bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.load()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(M)) <= 64 * 1024
    assert M["paths"] == ["h100bench"]
    assert 1 <= M["run_seconds"] <= 51
    cells = len(M["workloads"])
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_lines():
    man = manifest.load(deferred=True)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names)), group
        for e in man[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")


@pytest.mark.parametrize("deferred", [False, True])
def test_cells_resolve_and_report(deferred):
    man = manifest.load(deferred=deferred)
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in man["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = manifest.cell(w["name"], man)
        assert cell.config["limits"]
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(manifest.reader(m["name"]))
        for m in cell.per_layer:
            assert m["moves"] in reported


def test_each_config_used_and_file_under_paths():
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("h100bench/")
        assert c["source"].startswith("https://")
        assert c["reduced"] == []


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        manifest.cell("no_such_cell")


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A later PR adds a traffic mix, a cell and a metric by adding files
    and entries: the harness finds them by name."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics" / "new_metric.x.py").write_text(
        "def read(ctx):\n    return ctx.n * 2\n")
    (tmp_path / "traffic" / "new_mix.json").write_text('{"pool": 3}')
    m = json.loads(json.dumps(M))
    m["workloads"].append(dict(m["workloads"][0], name="new_cell",
                               traffic="new_mix"))
    m["per_layer"].append({"name": "new_metric.x", "unit": "%",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "setup_s",
                           "workloads": ["new_cell"]})
    monkeypatch.setattr(manifest, "BENCH", tmp_path)
    cell = manifest.cell("new_cell", manifest=m)
    assert cell.traffic == {"pool": 3}
    assert [x["name"] for x in cell.per_layer][-1] == "new_metric.x"
    from types import SimpleNamespace
    assert manifest.reader("new_metric.x")(SimpleNamespace(n=3)) == 6
