"""The port's ``config.FusionConfig`` and ``utils/profiling.py``
(``PhaseTimer.record``, ``print_profile``) against the JAX package's:
a JSON written by either package loads in the other with equal fields,
and ``print_profile`` prints the same lines for the same dumped file."""

import dataclasses
import random

import pytest

from dynamicfusion_body_tpu import config as jcfg
from dynamicfusion_body_tpu.utils import profiling as jprof
from dynamicfusion_body_tpu_torch import config as tcfg
from dynamicfusion_body_tpu_torch.utils import profiling as tprof


def test_fusion_config_fields_and_defaults():
    jf = [(f.name, f.type) for f in dataclasses.fields(jcfg.FusionConfig)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tcfg.FusionConfig)]
    assert tf == jf
    assert (dataclasses.asdict(tcfg.FusionConfig())
            == dataclasses.asdict(jcfg.FusionConfig()))


def _custom(mod):
    return mod.FusionConfig(
        trunc_distance=0.35, subsample_rate=2.0, knn=3,
        marching_cubes_step_size=1, tolerance=1e9, regularization_weight=5.0,
        method="cnn", use_cnn=True, write_warpfield=False, verbose=True,
        capacities=mod.CapacityConfig(vert_cap=4096, face_cap=8192,
                                      node_cap=256),
        gn_iters=4, cg_iters=16)


@pytest.mark.parametrize("writer,reader", [(jcfg, tcfg), (tcfg, jcfg),
                                           (tcfg, tcfg)])
@pytest.mark.parametrize("cls", ["FusionConfig", "FusionDMConfig"])
def test_config_json_both_ways(tmp_path, writer, reader, cls):
    if cls == "FusionConfig":
        cfg = _custom(writer)
    else:
        cfg = writer.FusionDMConfig(
            tsdf_res=128, use_icp=True,
            camera=writer.CameraConfig(fx=500.0, cx=320.0))
    path = str(tmp_path / "cfg.json")
    writer.save_config(cfg, path)
    back = reader.load_config(getattr(reader, cls), path)
    assert type(back) is getattr(reader, cls)
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    # the nested dataclass comes back as the reader's own class
    assert type(back.capacities) is reader.CapacityConfig


def _dumped(mod, tmp_path):
    """A profile dumped by ``mod``'s PhaseTimer from seeded ``record``
    calls (and one timed phase), and its path."""
    rnd = random.Random(0)
    t = mod.PhaseTimer()
    for name in ("solve", "updateTSDF", "setupCorrespondences", "mc",
                 "update_graph"):
        for _ in range(rnd.randint(1, 5)):
            t.record(name, rnd.uniform(1e-4, 3.0))
    with t.phase("io"):
        pass
    path = tmp_path / f"{mod.__name__.split('.')[0]}.json"
    t.dump(str(path))
    return t, path


def test_phase_timer_record_matches_jax(tmp_path):
    tt, _ = _dumped(tprof, tmp_path)
    jt, _ = _dumped(jprof, tmp_path)
    ts, js = tt.summary(), jt.summary()
    assert ts.keys() == js.keys()
    for name in ts:
        if name != "io":   # the one wall-timed phase
            assert ts[name] == js[name]
    assert ts["io"]["count"] == js["io"]["count"] == 1


@pytest.mark.parametrize("sort", ["total_s", "mean_s", "count"])
def test_print_profile_prints_jax_lines(tmp_path, capsys, sort):
    _, path = _dumped(jprof, tmp_path)
    jprof.print_profile(str(path), sort=sort)
    want = capsys.readouterr().out
    tprof.print_profile(str(path), sort=sort)
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 6
    # the port's report() prints the same line format
    tt, tpath = _dumped(tprof, tmp_path)
    tprof.print_profile(str(tpath), sort="total_s")
    lines = capsys.readouterr().out.splitlines()
    assert sorted(lines) == sorted(tt.report().splitlines())
