"""The roofline yardstick against hand counts at tiny shapes."""

import math

import torch

from h100bench import counts


def test_bound_is_the_larger_side():
    assert math.isclose(counts.bound_ms(3.35e9, 0), 1.0)
    assert math.isclose(counts.bound_ms(0, 67e9), 1.0)
    assert math.isclose(counts.bound_ms(3.35e9, 134e9), 2.0)


def test_k1_bound_by_hand():
    # 2x3x4 = 24 voxels read (96 B) and 24 words written (96 B)
    assert math.isclose(counts.k1_bound_ms((2, 3, 4)),
                        192 / 3.35e12 * 1e3)


def test_live_taps_by_hand():
    shape = (4, 4, 4)
    # one sample at a lattice point taps its cell and the 7 above it
    one = torch.tensor([[1.0]])
    assert counts.live_taps(shape, one, one, one) == 8
    # two samples in the same cell tap the same 8 cells
    two = torch.tensor([[1.2, 1.7]])
    assert counts.live_taps(shape, two, two, two) == 8
    # at the far corner the clamped corners coincide: 1 cell
    far = torch.tensor([[3.0]])
    assert counts.live_taps(shape, far, far, far) == 1


def test_live_mip_by_hand():
    live = torch.arange(16 ** 3, dtype=torch.float32).reshape(16, 16, 16)
    mn, mx = counts.live_mip(live)
    assert mn.shape == (2, 2, 2)
    # brick (0,0,0) spans voxels 0..8 on each axis (with its halo)
    assert float(mn[0, 0, 0]) == 0.0
    assert float(mx[0, 0, 0]) == float(8 * 256 + 8 * 16 + 8)
    # the last brick's halo is clamped to the volume
    assert float(mx[1, 1, 1]) == float(16 ** 3 - 1)


def test_short_bricks_by_hand():
    shape = (24, 24, 24)
    live = -5.0 - 0.01 * torch.arange(24.0)[:, None, None].expand(shape)
    live = live.clone()
    live[16:] = 3.0
    mip = counts.live_mip(live)
    w = torch.full((3, 4), 2.0)
    valid = torch.ones((3, 4), dtype=torch.bool)
    valid[2] = False
    wx = w.clone()
    wx[1] = 20.0                      # brick 1 reads the +3 region
    short = counts.short_bricks(wx, w, w, valid, shape, 4.0, mip)
    # brick 0: every tap <= -tdist (and not one value); brick 1: every
    # tap 3.0; brick 2: no sample in the volume
    assert short.tolist() == [True, True, True]
    short = counts.short_bricks(wx, w, w, valid, shape, 6.0, mip)
    assert short.tolist() == [False, True, True]


def test_k2_bound_by_hand():
    live = torch.zeros((16, 16, 16))
    live[8:] = 1.0
    nb, v = 2, 8
    wx = torch.full((nb, v), 7.5)         # straddles the step: full bricks
    wy = torch.full((nb, v), 1.0)
    wz = torch.full((nb, v), 1.0)
    valid = torch.ones((nb, v), dtype=torch.bool)
    got = counts.k2_bound_ms(live, wx, wy, wz, valid, 10.0, n_nodes=5, k=3,
                             C=4)
    taps = 8
    nbytes = (4 * taps + 32 * 5 + 4 * nb * 4 + 4 * nb * v + 4 * nb * 3 * v
              + 32 + 2 * 4 * 8 + 4 * nb * v + nb * v)
    nops = nb * v * 216 + nb * v * 40
    assert math.isclose(got, counts.bound_ms(nbytes, nops))


def test_k5_bound_by_hand():
    got = counts.k5_bound_ms((2, 2, 2), 3, 4, 5, n_inb=10, n_upd=4)
    nbytes = 16 * 8 + 4 * (3 * 20 + 36 + 3)
    nops = 8 * 3 * 24 + 10 * 29 + 4 * 7
    assert math.isclose(got, counts.bound_ms(nbytes, nops))
