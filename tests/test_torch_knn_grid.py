"""K7's plain twin (``ops/knn_grid_cuda.py:knn_grid`` on CPU tensors) on
the CPU: the exact k nearest by direct-difference distance, ties to the
lower index, over the counted rows, against an exhaustive search and
against the flat search (``ops/knn.py:knn``) it stands in for in the ICP
branch.

The flat search ranks on the expanded form ‖q‖² − 2q·p + ‖p‖², whose
rounding can swap neighbours whose distances differ by a few ulps. Where
every coordinate is a small multiple of 1/4 both forms are exact, and
the two searches must agree index for index, ties included; elsewhere
they must agree on every query whose neighbours are not that close, and
the twin must equal the exhaustive search everywhere.

The kernel itself runs on the card only: ``python -m
dynamicfusion_body_tpu_torch.tools.profile_knn_grid`` holds it to this
twin there, slot for slot."""

import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu_torch.ops import knn_grid_cuda as K7
from dynamicfusion_body_tpu_torch.ops.knn import knn
from dynamicfusion_body_tpu_torch.ops.marching_cubes import marching_cubes

torch.set_num_threads(1)


def exhaustive(q, p, k, nq, npt):
    """(dists, idx) by a stable sort of every direct-difference distance."""
    d = q[:nq, None, :] - p[None, :npt, :]
    d2 = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
          + d[..., 2] * d[..., 2])
    s = torch.sort(d2, dim=1, stable=True)
    return torch.sqrt(s.values[:, :k].double()).float(), s.indices[:, :k]


def run(q, p, k, nq, npt, extent, cell=None):
    return K7.knn_grid(q, p, k, torch.tensor(nq), torch.tensor(npt), extent,
                       cell)


def near_tied(q, p, k, nq, npt):
    """Queries whose k-th and (k+1)-th distances, or any two of the first
    k, lie within what the expanded form's float32 rounding can swap: 16
    ulps of ‖q‖² + ‖p‖², the size of its terms."""
    q, p = q[:nq].double(), p[:npt].double()
    d = q[:, None, :] - p[None, :, :]
    d2 = torch.sort((d * d).sum(-1), dim=1).values[:, :k + 1]
    scale = (q * q).sum(1) + (p * p).sum(1).max()
    gaps = (d2[:, 1:] - d2[:, :-1]) <= 16 * 2.0**-24 * scale[:, None]
    return gaps.any(1)


def bumpy_mesh(res, centre, radius, phase):
    g = torch.arange(res, dtype=torch.float32)
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    r = torch.sqrt((x - centre[0]) ** 2 + (y - centre[1]) ** 2
                   + (z - centre[2]) ** 2)
    sdf = r - radius - 1.5 * torch.sin(0.4 * x + phase) * torch.cos(0.3 * y)
    m = marching_cubes(sdf, vert_cap=1 << 15, face_cap=1 << 16,
                       with_normals=False)
    return m["verts"], int(m["n_verts"])


@pytest.mark.parametrize("cell", [None, 8.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_random_clouds(seed, k, cell):
    """Clouds on a 32³ lattice, some queries outside it; the tree 6 levels
    deep at the default half-voxel cells, 2 at 8-voxel ones."""
    g = torch.Generator().manual_seed(seed)
    q = torch.rand(1500, 3, generator=g) * 44 - 6
    p = torch.rand(1800, 3, generator=g) * 32
    nq, npt = 1400, 1700
    d, i = run(q, p, k, nq, npt, 32.0, cell)
    ed, ei = exhaustive(q, p, k, nq, npt)
    assert torch.equal(i[:nq], ei) and torch.equal(d[:nq], ed)
    fd, fi = knn(q[:nq], p, k, valid=torch.arange(1800) < npt)
    clear = ~near_tied(q, p, k, nq, npt)
    assert clear.float().mean() > 0.95
    assert torch.equal(fi[clear], i[:nq][clear])
    torch.testing.assert_close(fd, d[:nq], rtol=0, atol=1e-4)


@pytest.mark.parametrize("k", [1, 4, 5])
def test_dyadic_ties_match_flat(k):
    """Quarter-voxel coordinates: every distance exact in both forms, many
    exact ties; the twin equals the flat search index for index."""
    g = torch.Generator().manual_seed(7)
    q = torch.randint(-8, 140, (1200, 3), generator=g).float() / 4
    p = torch.randint(0, 128, (1500, 3), generator=g).float() / 4
    d, i = run(q, p, k, 1200, 1500, 32.0)
    fd, fi = knn(q, p, k)
    assert torch.equal(i, fi)
    # the CPU's float32 sqrt, which the flat search takes, may round the
    # other way; the twin's is correctly rounded, as the card's sqrtf
    torch.testing.assert_close(d, fd, rtol=2.5e-7, atol=0)
    ed, ei = exhaustive(q, p, k + 1, 1200, 1500)
    assert torch.equal(i, ei[:, :k])
    # ties are common here (the k-th with the next one too), and go to the
    # lower index
    d2 = ed * ed
    tie = d2[:, 1:] == d2[:, :-1]
    assert tie.any() and (ei[:, 1:][tie] > ei[:, :-1][tie]).all()


def test_marching_cubes_clouds():
    """Two meshes' vertices on one 48³ lattice (queries: one mesh moved
    by a rigid pose, points: the other), as the ICP searches them."""
    pts, npt = bumpy_mesh(48, (24.0, 24.0, 24.0), 14.0, 0.0)
    cv, nq = bumpy_mesh(48, (23.0, 25.0, 24.5), 13.0, 0.7)
    ang = 0.05
    rot = torch.tensor([[np.cos(ang), -np.sin(ang), 0.0],
                        [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]],
                       dtype=torch.float32)
    q = (cv - 24.0) @ rot.T + 24.0 + torch.tensor([0.4, -0.3, 0.2])
    d, i = run(q, pts, 4, nq, npt, 48.0)
    ed, ei = exhaustive(q, pts, 4, nq, npt)
    assert torch.equal(i[:nq], ei) and torch.equal(d[:nq], ed)
    fd, fi = knn(q[:nq], pts, 4, valid=torch.arange(pts.shape[0]) < npt)
    # lattice-edge vertices tie often: fewer queries are clear of ties
    clear = ~near_tied(q, pts, 4, nq, npt)
    assert clear.float().mean() > 0.8
    assert torch.equal(fi[clear], i[:nq][clear])
    torch.testing.assert_close(fd, d[:nq], rtol=0, atol=1e-4)


def test_far_queries_and_points_past_the_grid():
    """Queries 100+ voxels from every point, and points outside the
    lattice the grid covers (clamped into its face cells)."""
    g = torch.Generator().manual_seed(3)
    p = torch.rand(900, 3, generator=g) * 40 - 4        # some below 0, > 32
    q = torch.cat([torch.rand(300, 3, generator=g) * 40 - 4,
                   torch.rand(300, 3, generator=g) * 50 + 130,
                   -torch.rand(300, 3, generator=g) * 50 - 100])
    d, i = run(q, p, 4, 900, 900, 32.0)
    ed, ei = exhaustive(q, p, 4, 900, 900)
    assert torch.equal(i, ei) and torch.equal(d, ed)
    assert (d[300:] > 90).all()


def test_counted_rows():
    """Rows past the counts are left out: points there are never found
    (their coordinates here lie nearest to every query), queries there get
    (+inf, 0), as do non-finite queries and the slots of a query left
    without k points; no point at all leaves every slot so."""
    g = torch.Generator().manual_seed(5)
    p = torch.rand(600, 3, generator=g) * 30
    q = torch.rand(500, 3, generator=g) * 30
    p[400:] = q[:200].repeat(1, 1)                     # bait past n_p
    q[450:] = torch.nan
    q[10] = torch.tensor([torch.inf, 1.0, 1.0])
    d, i = run(q, p, 4, 420, 400, 32.0)
    assert (i[:420] < 400).all()
    ed, ei = exhaustive(q, p, 4, 420, 400)
    ok = torch.isfinite(q[:420]).all(1)
    assert torch.equal(i[:420][ok], ei[ok]) and torch.equal(d[:420][ok],
                                                            ed[ok])
    assert torch.isinf(d[420:]).all() and (i[420:] == 0).all()
    assert torch.isinf(d[10]).all() and (i[10] == 0).all()
    fd, fi = knn(q[:420][ok], p, 4, valid=torch.arange(600) < 400)
    clear = ~near_tied(q[:420][ok], p, 4, int(ok.sum()), 400)
    assert torch.equal(fi[clear], i[:420][ok][clear])
    d3, i3 = run(q, p, 4, 50, 3, 32.0)
    assert torch.isinf(d3[:50, 3]).all() and (i3[:50, 3] == 0).all()
    assert torch.isfinite(d3[:50, :3][ok[:50]]).all()
    d0, i0 = run(q, p, 4, 50, 0, 32.0)
    assert torch.isinf(d0).all() and (i0 == 0).all()


def test_cell_codes_and_levels():
    """The grid covers the lattice with 2^L cells of ``cell`` voxels;
    cell codes interleave x, y, z bits (x lowest), clamped at the faces."""
    assert K7.grid_levels(512, 2.0) == 8 and K7.grid_levels(32, 2.0) == 4
    assert K7.grid_levels(512, 1.0) == 9 and K7.grid_levels(1, 1.0) == 1
    assert K7.grid_levels(5000, 1.0) == K7.MAX_LEVELS
    # by default 64 cells a side: 8 voxels at 512³, half a voxel at 32³
    assert [K7.leaf_cell(e) for e in (512, 256, 48, 32)] == [8, 4, 1, 0.5]
    pts = torch.tensor([[2.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 2.0],
                        [3.9, 5.0, 1.0], [-7.0, 99.0, float("nan")]])
    c = K7.cell_codes(pts, 4, 2.0)
    # (1,0,0), (0,1,0), (0,0,1); (1,2,0): x bit 0, y bit 1 at 3·1 + 1;
    # (0,15,0): y bits 0-3 at 1, 4, 7, 10
    assert c.tolist() == [1, 2, 4, 1 | (1 << 4),
                          (1 << 1) | (1 << 4) | (1 << 7) | (1 << 10)]


def test_refuses_what_the_kernel_takes_not():
    q = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="k = 9"):
        K7.knn_grid(q, q, 9, 4, 4, 8.0)
    with pytest.raises(ValueError, match="float32"):
        K7.knn_grid(q.double(), q, 4, 4, 4, 8.0)
