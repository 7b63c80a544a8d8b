"""K6 (ops/trilerp_cuda.py:trilerp_ablation), the port of the TPU trilerp
ablation in tools/profile_trilerp.py, through its plain twin: ``full`` is
K4's trilerp (and JAX's ``trilerp_bricks`` within K4's tolerance),
``loads`` and ``weights`` equal numpy oracles of their formulas, and the
wrapper routes CPU tensors to the twin and refuses an unknown mode or
block size. The kernel itself is held to the twin on the card by
chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu.ops import trilerp_pallas as JP
from dynamicfusion_body_tpu_torch.ops import trilerp_cuda as TP
from dynamicfusion_body_tpu_torch.tools._scene import trilerp_inputs
from test_torch_warp_trilerp_bricks import k4_inputs

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def oracle(live, w, mode):
    """numpy float32: the index step of _trilinear_c, then the 8 taps or
    the 8 weight products summed over the corners, x fastest."""
    shape = live.shape
    idx, frac = [], []
    for c, r in zip(w, shape):
        f = np.clip(c, np.float32(0), np.float32(r - 1)).astype(np.float32)
        i0 = np.floor(f).astype(np.int64)
        idx.append((i0, np.minimum(i0 + 1, r - 1)))
        frac.append(f - i0.astype(np.float32))
    one = np.float32(1)
    ws = [(one - d, d) for d in frac]
    out = None
    for c in range(8):
        a, b, d = c & 1, (c >> 1) & 1, c >> 2
        if mode == "loads":
            term = live[idx[0][a], idx[1][b], idx[2][d]]
        else:
            term = ws[0][a] * ws[1][b] * ws[2][d]
        out = term if out is None else out + term
    return out.astype(np.float32)


def fixtures(rng):
    """K4's test fixture (samples outside the volume, one on the far
    corner) and the profiling tool's own samples at 32³."""
    live, w = k4_inputs(rng)
    tool = [a.numpy() for a in trilerp_inputs(32, torch.device("cpu"))]
    return [(live, w), (tool[0], np.stack(tool[1:]))]


def test_full_twin_is_k4_and_matches_pallas(rng):
    for i, (live, w) in enumerate(fixtures(rng)):
        got = TP.trilerp_ablation_ref(T(live), *map(T, w), "full")
        k4 = TP.trilerp_bricks_ref(T(live), *map(T, w))
        assert torch.equal(got, k4[0])
        if i:  # the tool's samples: JAX needs (NB, 512) rows in the volume
            w = w[:, :64]
        jv, jvalid, jesc = (np.asarray(a) for a in JP.trilerp_bricks(
            jnp.asarray(live), *(jnp.asarray(c) for c in w), group=1,
            interpret=True, precise=True))
        ok = jvalid & ~jesc
        assert ok.mean() > 0.9
        got = TP.trilerp_ablation_ref(T(live), *map(T, w), "full").numpy()
        np.testing.assert_allclose(got[ok], jv[ok],
                                   atol=2.0 ** -16 * np.abs(live).max())


@pytest.mark.parametrize("mode", ["loads", "weights"])
def test_parts_match_numpy_oracle(rng, mode):
    for live, w in fixtures(rng):
        got = TP.trilerp_ablation_ref(T(live), *map(T, w), mode).numpy()
        want = oracle(live, w, mode)
        if mode == "loads":
            np.testing.assert_array_equal(got, want)
        else:  # within 1 ulp; a partition of unity, so within 1e-6 of 1
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
            np.testing.assert_allclose(got, 1.0, atol=1e-6)


@pytest.mark.parametrize("threads", [128, 256, 512])
@pytest.mark.parametrize("mode", ["loads", "weights", "full"])
def test_wrapper_takes_the_twin_on_cpu(rng, mode, threads):
    live, w = k4_inputs(rng)
    before = TP.trilerp_ablation.launches
    got = TP.trilerp_ablation(T(live), *map(T, w), mode, threads)
    assert torch.equal(got, TP.trilerp_ablation_ref(T(live), *map(T, w),
                                                    mode))
    assert got.shape == w[0].shape and got.dtype == torch.float32
    assert TP.trilerp_ablation.launches == before  # no kernel launched


@pytest.mark.parametrize("mode,threads", [("dma_only", 256), ("full", 8),
                                          ("weights", 1024)])
def test_wrapper_refuses_unknown_mode_or_block(rng, mode, threads):
    live, w = k4_inputs(rng)
    with pytest.raises(ValueError, match="trilerp_ablation"):
        TP.trilerp_ablation(T(live), *map(T, w), mode, threads)
    if mode == "dma_only":
        with pytest.raises(ValueError, match="mode"):
            TP.trilerp_ablation_ref(T(live), *map(T, w), mode)
