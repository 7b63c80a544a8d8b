"""Finds a cell's parts by the names in ``BENCHMARK.json``: its
configuration (the ``file`` of its ``configs`` entry, a JSON object whose
``entry`` names the driver in ``drivers/``), its traffic
(``traffic/<traffic>.json``), and its metrics (``metrics/<name>.py`` for
each metric the cell reports). Adding a cell, a mix or a metric adds
files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load(root: Path = ROOT, deferred: bool = False) -> dict:
    """``BENCHMARK.json``; with ``deferred``, with the entries of
    ``deferred.json`` (cells kept out of the manifest) added."""
    with open(root / "BENCHMARK.json") as f:
        m = json.load(f)
    if deferred:
        with open(BENCH / "deferred.json") as f:
            extra = json.load(f)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            m[key] = m[key] + extra[key]
    return m


def _reports(metric: dict, cell: str, e2e_names=()) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return not e2e_names or metric["moves"] in e2e_names


def cell(name: str, manifest: dict | None = None,
         root: Path = ROOT) -> SimpleNamespace:
    """The cell ``name``: its manifest entry, configuration and traffic
    (parsed), and the end-to-end and per-layer metric entries it
    reports."""
    m = manifest if manifest is not None else load(root)
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [x for x in m["end_to_end"] if _reports(x, name)]
    names = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"] if _reports(x, name, names)]
    return SimpleNamespace(name=name, workload=w, config=config,
                           traffic=traffic, end_to_end=e2e,
                           per_layer=per_layer, chips=w["chips"])


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
