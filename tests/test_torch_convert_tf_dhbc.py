"""The port's TF-checkpoint converter
(``dynamicfusion_body_tpu_torch/tools/convert_tf_dhbc.py``) against the
JAX package's (``tools/convert_tf_dhbc.py``), on a fake checkpoint drawn
from a seed per the manifest, as ``tests/test_dhbc_convert.py`` does:
the manifest copy equals the JAX one, the converted arrays equal JAX's,
they cover every parameter of the port's DHBC, and a 64² forward of the
converted weights in the port is within 1e-4 (relative to the output's
largest magnitude) of JAX's forward on the same npz. Without tensorflow
``main`` exits with the JAX tool's message."""

import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu.models import dhbc as jd
from dynamicfusion_body_tpu_torch.models import dhbc as td
from dynamicfusion_body_tpu_torch.tools import convert_tf_dhbc as tconv

ROOT = Path(__file__).resolve().parent.parent
SIZE = 64
FWD_RTOL = 1e-4

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_tf_dhbc", ROOT / "tools" / "convert_tf_dhbc.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jconv():
    return _jax_tool()


@pytest.fixture(scope="module")
def fake_checkpoint():
    rng = np.random.RandomState(0)
    return {n: rng.randn(*s).astype(np.float32) * 0.01
            for n, s in tconv.load_manifest().items()}


def test_manifest_copy_equals_jax(jconv):
    with open(ROOT / "tools" / "dhbc_tf_manifest.json") as f:
        want = json.load(f)
    assert tconv.load_manifest() == want == jconv.load_manifest()
    assert list(tconv.load_manifest()) == list(want)   # same order
    assert Path(tconv.MANIFEST_PATH).parent == Path(tconv.__file__).parent


def test_arrays_equal_jax(jconv, fake_checkpoint):
    got = tconv.convert_var_dict(fake_checkpoint)
    want = jconv.convert_var_dict(fake_checkpoint)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_covers_every_port_parameter(fake_checkpoint, tmp_path):
    out = tconv.convert_var_dict(fake_checkpoint)
    npz = tmp_path / "ref.npz"
    np.savez(npz, **out)
    assert td.npz_normalize_input(str(npz)) is False
    assert td.npz_feature_norm(str(npz)) is False
    model, params = td.init_dhbc(3, normalize_input=False, device="cpu")
    converted = {k for k in out if not k.startswith("__")}
    from dynamicfusion_body_tpu_torch.convert import dhbc_flax_key
    assert {dhbc_flax_key(k) for k in params} == converted
    loaded = td.load_npz_params(params, str(npz))
    for k, p in loaded.items():
        assert p.shape == params[k].shape, k
    # the loaded tensors ARE the converted data (OIHW of the HWIO arrays)
    np.testing.assert_array_equal(
        loaded["convs.0.weight"].detach().numpy(),
        out["params/_Conv_0/Conv_0/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(loaded["convs.14.bias"].detach().numpy(),
                                  out["params/_Conv_14/Conv_0/bias"])


def test_forward_matches_jax(jconv, fake_checkpoint, tmp_path):
    """JAX converts and loads into Flax; the port converts and loads into
    its module; the same raw 0..255 depth goes through both."""
    npz_j = tmp_path / "jax.npz"
    npz_t = tmp_path / "port.npz"
    np.savez(npz_j, **jconv.convert_var_dict(fake_checkpoint))
    np.savez(npz_t, **tconv.convert_var_dict(fake_checkpoint))
    rng = np.random.RandomState(1)
    depth8 = np.floor(rng.rand(1, SIZE, SIZE) * 256).astype(np.float32)

    jm, jp = jd.init_dhbc(0, SIZE, SIZE, normalize_input=False)
    jp = jd.load_npz_params(jp, str(npz_j))
    want = np.asarray(jm.apply(jp, jnp.asarray(depth8[..., None])))

    tm, tp = td.init_dhbc(0, normalize_input=False, device="cpu")
    tp = td.load_npz_params(tp, str(npz_t))
    with torch.no_grad():
        got = torch.func.functional_call(
            tm, tp, (torch.from_numpy(depth8[:, None]),))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, SIZE, SIZE, 16)
    scale = float(np.abs(want).max())
    assert scale > 0 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_RTOL * scale)


def test_rejects_wrong_shapes(fake_checkpoint):
    bad = dict(fake_checkpoint)
    bad["feature/encoder/Conv/weights"] = np.zeros((11, 11, 1, 95),
                                                   np.float32)
    with pytest.raises(ValueError, match="shape"):
        tconv.convert_var_dict(bad)
    del bad["feature/encoder/Conv/weights"]
    with pytest.raises(ValueError, match="missing"):
        tconv.convert_var_dict(bad)


def test_main_without_tensorflow(jconv, monkeypatch, tmp_path):
    """Both tools exit with the same message when tensorflow cannot be
    imported (None in sys.modules makes the import raise)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    argv = ["--checkpoint", str(tmp_path / "model"), "--out",
            str(tmp_path / "o.npz")]
    with pytest.raises(SystemExit) as got:
        tconv.main(argv)
    monkeypatch.setattr(sys, "argv", ["convert_tf_dhbc.py", *argv])
    with pytest.raises(SystemExit) as want:
        jconv.main()
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("tensorflow is required")
    assert not (tmp_path / "o.npz").exists()
