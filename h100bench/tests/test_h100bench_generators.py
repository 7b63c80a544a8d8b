"""The inputs are a function of the seed: the same seed gives the same
volumes and captures, another seed other ones."""

import importlib

import torch

from h100bench.tests._small import small_cell

CPU = torch.device("cpu")


def _driver(name, seed):
    cell = small_cell(name)
    mod = importlib.import_module(
        f"h100bench.drivers.{cell.config['entry']}")
    return mod.Driver(cell.config, cell.traffic, seed, CPU)


def test_tracking_inputs_follow_the_seed():
    seed = 2 ** 31 + 12345
    a, b, c = (_driver("track_256_still", s) for s in (seed, seed, seed + 1))
    assert a.live_params == b.live_params != c.live_params
    assert all(torch.equal(x, y) for x, y in zip(a.lives, b.lives))
    assert torch.equal(a.canonical, b.canonical)
    assert not torch.equal(a.canonical, c.canonical)
    # the still mix: 8 jittered centres at one phase, cycled
    assert len(a.lives) == 8 and a.schedule == list(range(8))


def test_motion_schedule_plays_the_phases_forward_and_back():
    d = _driver("track_256_motion", 7)
    phases = [d.live_params[i]["phase"] - d.phase0 for i in d.schedule]
    steps = [round(p / 0.05) for p in phases]
    assert steps == [0, 1, 2, 3, 4, 5, 6, 5, 4, 3, 2, 1]
    assert len(d.lives) == 7


def test_captures_follow_the_seed():
    seed = 2 ** 33 + 7
    a, b, c = (_driver("ingest_512_mesh", s) for s in (seed, seed, seed + 1))
    for (da, la), (db, lb) in zip(a.pool, b.pool):
        assert all((x == y).all() for x, y in zip(da, db))
        assert (la == lb).all()
    assert any(not (x == y).all() for x, y in zip(a.pool[0][0],
                                                   c.pool[0][0]))
    assert all((d != 0).sum() > 100 for d in a.pool[0][0])
