"""K6's per-row tap box (ops/trilerp_cuda.py:trilerp_box_rows), the plain
predicate that csrc/trilerp_ablation.cu follows when it decides which rows
to stage in shared memory: on the profiling tool's samples every row fits
and holds every tap of its samples; on K4's fixture (samples outside the
volume, one on the far corner) the extents are the clamped ones and no row
is staged; a row one cell wider than the box, or with a sample on a far
face of the volume, is not staged; 1-D inputs are cut into rows of 512;
and the wrapper on CPU tensors takes the twin, fills ``row_map`` from the
predicate and launches nothing. The kernel's row map is held to the
predicate on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu_torch.ops import trilerp_cuda as TP
from dynamicfusion_body_tpu_torch.tools._scene import trilerp_inputs
from test_torch_warp_trilerp_bricks import k4_inputs

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)

BOX = np.array(TP.ABLATION_BOX)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def np_boxes(shape, w, V):
    """numpy: per row of V samples, the clamped tap extent's origin (z
    rounded down to 4), its size from there, and whether the kernel stages
    it (the size fits the box and every x0 <= rx - 2, and so on)."""
    lo, hi, top = [], [], []
    for c, r in zip(w, shape):
        c = c.reshape(-1)
        f = np.floor(np.clip(c, np.float32(0), np.float32(r - 1)))
        i0 = f.astype(np.int64)
        i1 = np.minimum(i0 + 1, r - 1)
        lo.append([i0[s:s + V].min() for s in range(0, c.size, V)])
        hi.append([i1[s:s + V].max() for s in range(0, c.size, V)])
        top.append([i0[s:s + V].max() for s in range(0, c.size, V)])
    lo, hi, top = np.array(lo).T, np.array(hi).T, np.array(top).T
    lo[:, 2] -= lo[:, 2] % 4
    size = hi - lo + 1
    fits = ((size <= BOX) & (top < np.array(shape) - 1)).all(1)
    return lo, size, fits


def taps(shape, w):
    """Every sample's 8 tap indices, (n, 8, 3)."""
    idx = []
    for c, r in zip(w, shape):
        c = c.reshape(-1)
        i0 = np.floor(np.clip(c, 0, r - 1)).astype(np.int64)
        idx.append((i0, np.minimum(i0 + 1, r - 1)))
    return np.stack([np.stack([idx[0][c & 1], idx[1][(c >> 1) & 1],
                               idx[2][c >> 2]], -1) for c in range(8)], 1)


def test_tool_rows_fit_and_hold_every_tap():
    live, wx, wy, wz = trilerp_inputs(32, torch.device("cpu"))
    origin, extent, fits = TP.trilerp_box_rows(live.shape, wx, wy, wz)
    rows, V = wx.shape
    assert origin.shape == extent.shape == (rows, 3) and fits.all()
    assert (extent.numpy() <= BOX).all() and (origin[:, 2] % 4 == 0).all()
    t = taps(live.shape, [c.numpy() for c in (wx, wy, wz)])
    t = t.reshape(rows, V * 8, 3)
    o = origin.numpy()[:, None]
    assert ((t >= o) & (t < o + extent.numpy()[:, None])).all()
    # the box is the rows' extent, not a bound: its first cells (z rounded
    # down to 4) and its last are taps
    np.testing.assert_array_equal(t.min(1)[:, :2], origin.numpy()[:, :2])
    assert (t.min(1)[:, 2] - origin.numpy()[:, 2] < 4).all()
    np.testing.assert_array_equal(t.max(1) - origin.numpy() + 1,
                                  extent.numpy())


def test_k4_fixture_extents_are_clamped(rng):
    live, w = k4_inputs(rng)
    origin, extent, fits = TP.trilerp_box_rows(live.shape, *map(T, w))
    lo, size, staged = np_boxes(live.shape, w, w.shape[-1])
    np.testing.assert_array_equal(origin.numpy(), lo)
    np.testing.assert_array_equal(extent.numpy(), size)
    np.testing.assert_array_equal(fits.numpy(), staged)
    R = live.shape[0]
    assert origin[0, 0] == 0  # samples at x = -2 clamp to cell 0
    assert origin[1, 1] + extent[1, 1] == R  # y = R + 3 clamps to R - 1
    assert origin[2, 0] + extent[2, 0] == R  # the far corner: x1 = x0
    # brick-coherent samples with 0.7-voxel noise span 11-13 cells: every
    # row takes the global path
    assert not fits.any()


def box_row(extra_axis=None, lo=(4, 8, 12)):
    """A row of 512 samples whose tap extent from ``lo`` is the box
    exactly (the lowest sample on lo, the highest floor one cell short of
    the box's end: its upper tap ends the box), one cell longer along
    ``extra_axis``."""
    rs = np.random.RandomState(1)
    lo = np.array(lo, np.float32)
    top = BOX - 2 + (np.arange(3) == extra_axis)
    w = lo + rs.rand(512, 3).astype(np.float32) * top
    w[0] = lo
    w[1] = lo + top + 0.5
    return w.T.copy()


@pytest.mark.parametrize("axis", [None, 0, 1, 2])
def test_row_one_cell_wider_than_the_box_does_not_fit(axis):
    shape = (48, 48, 48)
    origin, extent, fits = TP.trilerp_box_rows(shape,
                                               *map(T, box_row(axis)))
    want = BOX + (np.arange(3) == axis)
    np.testing.assert_array_equal(origin[0].numpy(), (4, 8, 12))
    np.testing.assert_array_equal(extent[0].numpy(), want)
    assert bool(fits[0]) == (axis is None)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_row_on_a_far_face_is_not_staged(axis):
    """A sample on a far face (x = rx - 1) has its upper tap clamped onto
    its lower one: the staged path's fixed tap offsets would be wrong, so
    the row takes the global path, however small its box."""
    w = box_row(None)
    shape = [48, 48, 48]
    shape[axis] = int(np.floor(w[axis].max())) + 1  # the top floor's face
    origin, extent, fits = TP.trilerp_box_rows(tuple(shape), *map(T, w))
    assert (extent[0].numpy() <= BOX).all() and not fits[0]
    shape[axis] += 1
    assert TP.trilerp_box_rows(tuple(shape), *map(T, w))[2][0]


def test_z_origin_rounds_down_to_four():
    """The z extent counts from the lowest floor rounded down to a multiple
    of 4: taps at z = 15..27 (13 cells) fill the box's 16 from z = 12, and
    one cell more does not fit, though 14 cells from z = 15 would."""
    shape = (48, 48, 48)
    w = box_row(None, lo=(4, 8, 15))
    w[2] = np.clip(w[2], 15, 26.5)  # floors 15..26, upper taps to 27
    origin, extent, fits = TP.trilerp_box_rows(shape, *map(T, w))
    assert int(origin[0, 2]) == 12 and int(extent[0, 2]) == 16 and fits[0]
    w[2, 1] = 27.5  # floor 27, upper tap 28: 17 cells from 12
    origin, extent, fits = TP.trilerp_box_rows(shape, *map(T, w))
    assert int(extent[0, 2]) == 17 and not fits[0]


@pytest.mark.parametrize("shape,want", [
    ((32768, 512), (32768, 512)), ((16, 64), (16, 64)),
    ((1000,), (2, 512)), ((3, 700), (5, 512)), ((2, 3, 5), (6, 5))])
def test_ablation_rows(shape, want):
    assert TP.ablation_rows(shape) == want


def test_1d_input_gives_rows_of_512(rng):
    live, w = k4_inputs(rng)
    n = 3 * 512 + 100
    flat = w.reshape(3, -1)[:, :n].copy()
    origin, extent, fits = TP.trilerp_box_rows(live.shape, *map(T, flat))
    assert origin.shape == (4, 3)
    lo, size, staged = np_boxes(live.shape, flat, 512)
    np.testing.assert_array_equal(origin.numpy(), lo)
    np.testing.assert_array_equal(extent.numpy(), size)
    np.testing.assert_array_equal(fits.numpy(), staged)
    # the short last row is its 100 samples' box
    lo_last, size_last, _ = np_boxes(live.shape, flat[:, 3 * 512:], 512)
    np.testing.assert_array_equal(origin[3].numpy(), lo_last[0])
    np.testing.assert_array_equal(extent[3].numpy(), size_last[0])
    out = TP.trilerp_ablation(T(live), *map(T, flat), "full")
    assert out.shape == (n,)


@pytest.mark.parametrize("mode", ["loads", "full"])
def test_wrapper_cpu_takes_twin_and_fills_row_map(rng, mode):
    live, w = k4_inputs(rng)
    tool = [a.numpy() for a in trilerp_inputs(32, torch.device("cpu"))]
    for live, w in ((live, w), (tool[0], np.stack(tool[1:]))):
        rows = TP.ablation_rows(w[0].shape)[0]
        row_map = torch.full((rows,), 7, dtype=torch.uint8)
        before = TP.trilerp_ablation.launches
        got = TP.trilerp_ablation(T(live), *map(T, w), mode, 128,
                                  row_map=row_map)
        assert TP.trilerp_ablation.launches == before  # no kernel launched
        assert torch.equal(got, TP.trilerp_ablation_ref(T(live), *map(T, w),
                                                        mode))
        fits = TP.trilerp_box_rows(live.shape, *map(T, w))[2]
        assert torch.equal(row_map, fits.to(torch.uint8))


@pytest.mark.parametrize("bad", ["shape", "dtype", "weights"])
def test_wrapper_refuses_a_wrong_row_map(rng, bad):
    """A row map of the wrong shape or type, or one for the weights mode,
    which stages nothing."""
    live, w = k4_inputs(rng)
    rows = TP.ablation_rows(w[0].shape)[0]
    row_map = (torch.zeros(rows + 1, dtype=torch.uint8) if bad == "shape"
               else torch.zeros(rows, dtype=torch.bool) if bad == "dtype"
               else torch.zeros(rows, dtype=torch.uint8))
    mode = "weights" if bad == "weights" else "full"
    with pytest.raises(ValueError, match="row_map"):
        TP.trilerp_ablation(T(live), *map(T, w), mode, row_map=row_map)
