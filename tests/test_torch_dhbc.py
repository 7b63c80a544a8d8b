"""Parity of the port's DHBC network (dynamicfusion_body_tpu_torch.models.
dhbc) with the JAX package's Flax module, on the CPU, with the Flax
parameters carried across by ``convert.dhbc_state_from_flax``:

* the forward at 64² (batch 2, both input scales), the zero-padded max
  pool on negative activations and the nearest 2x upsampling;
* the npz weights format both ways, with both markers;
* ``dhbc_loss`` (linear and cosine heads), ``coord_loss``, and three
  steps of ``make_train_step`` with the coordinate auxiliary and the
  global-norm clip (first step's loss and gradients elementwise, the
  later losses within a stated rtol: Adam turns float noise in
  near-zero gradients into ±lr steps, so the parameters are not held
  after several steps);
* ``furthest_point_sample`` and the numpy copies ``render/glmath.py`` and
  ``utils/colorcodec.py``.

As a script (``JAX_PLATFORMS=cpu python tests/test_torch_dhbc.py --seeds
0 1 2 3 [--port]``) it runs tests/test_dhbc.py's training loop from
JAX's ``init_dhbc(seed)``, in JAX or in the port, and prints the loss
and the held-out accuracy of each run: the loop's gate holds for some
initial draws and not for others.
"""

import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]  # run as a script

import flax  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dynamicfusion_body_tpu.models import dhbc as jd  # noqa: E402
from dynamicfusion_body_tpu.ops.sampling import (  # noqa: E402
    furthest_point_sample as j_fps)
from dynamicfusion_body_tpu.render import glmath as j_glmath  # noqa: E402
from dynamicfusion_body_tpu.utils import colorcodec as j_codec  # noqa: E402
from dynamicfusion_body_tpu_torch import convert  # noqa: E402
from dynamicfusion_body_tpu_torch.models import dhbc as td  # noqa: E402
from dynamicfusion_body_tpu_torch.ops.sampling import (  # noqa: E402
    furthest_point_sample as t_fps)
from dynamicfusion_body_tpu_torch.render import glmath as t_glmath  # noqa: E402
from dynamicfusion_body_tpu_torch.utils import colorcodec as t_codec  # noqa: E402

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)

SIZE = 64
# the forward's tolerance: relative to the output's largest magnitude
FWD_RTOL = 1e-4


def flax_pair(normalize_input=True, seed=0):
    """JAX (model, params) and the port's module with the same weights."""
    jm, jp = jd.init_dhbc(seed, SIZE, SIZE, normalize_input=normalize_input)
    tm, _ = td.init_dhbc(seed, normalize_input=normalize_input,
                         device="cpu")
    flat = flax.traverse_util.flatten_dict(jp, sep="/")
    tp = convert.dhbc_state_from_flax(
        {k: np.asarray(v) for k, v in flat.items()}, device="cpu")
    tm.load_state_dict(tp)
    return jm, jp, tm, dict(tm.named_parameters())


def depth_batch(rng, b=2):
    """depth8-like input: a background of 255 and a blob of 0..254."""
    d = np.full((b, SIZE, SIZE), 255.0, np.float32)
    d[:, 12:52, 16:48] = np.floor(rng.rand(b, 40, 32) * 255.0)
    return d


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x[:, None]))


@pytest.mark.parametrize("normalize_input", [True, False])
def test_forward_matches_flax(normalize_input):
    rng = np.random.RandomState(3)
    jm, jp, tm, _ = flax_pair(normalize_input)
    d = depth_batch(rng)
    want = np.asarray(jm.apply(jp, jnp.asarray(d[..., None])))
    with torch.no_grad():
        got = tm(to_nchw(d)).permute(0, 2, 3, 1).numpy()
        conv1 = torch.nn.functional.elu(tm.convs[0](
            to_nchw(d) * (1 / 255) - 0.5 if normalize_input else to_nchw(d)))
    assert got.shape == want.shape == (2, SIZE, SIZE, 16)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_RTOL * scale)
    # the first pool's border sees negative ELU outputs: a −∞-padded pool
    # would differ from the zero-padded one there
    border = torch.cat([conv1[..., 0, :].flatten(), conv1[..., -1, :].flatten()])
    assert (border < 0).any()


def test_pool_and_upsample_match_flax():
    """The zero-padded 3x3/s2 pool on all-negative inputs (where −∞
    padding would differ at every border window) and the nearest 2x
    upsampling, against the JAX module's helpers."""
    rng = np.random.RandomState(4)
    x = -rng.rand(2, 17, 16, 5).astype(np.float32) - 0.1
    want = np.asarray(jd._maxpool(jnp.asarray(x)))
    got = td._maxpool(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert (want[:, 0, :, :] == 0).all()  # the zero padding wins
    want = np.asarray(jd._upsample_nn(jnp.asarray(x)))
    got = td._upsample_nn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_npz_both_ways(tmp_path):
    """JAX save → port load and port save → JAX load give the same
    network outputs and read both markers."""
    rng = np.random.RandomState(5)
    d = depth_batch(rng, 1)
    jm, jp, tm, tp = flax_pair(False, seed=1)
    want = np.asarray(jm.apply(jp, jnp.asarray(d[..., None])))

    p1 = str(tmp_path / "from_jax.npz")
    jd.save_npz_params(jp, p1, normalize_input=False, feature_norm=True)
    assert td.npz_normalize_input(p1) is False
    assert td.npz_feature_norm(p1) is True
    _, fresh = td.init_dhbc(7, normalize_input=False, device="cpu")
    loaded = td.load_npz_params(fresh, p1)
    assert all(loaded[k].requires_grad for k in loaded)
    with torch.no_grad():
        got = torch.func.functional_call(tm, loaded, (to_nchw(d),))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=FWD_RTOL * np.abs(want).max())

    p2 = str(tmp_path / "from_port.npz")
    td.save_npz_params(tp, p2, normalize_input=True, feature_norm=False)
    assert jd.npz_normalize_input(p2) is True
    assert jd.npz_feature_norm(p2) is False
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jp)
    back = jd.load_npz_params(zeros, p2)
    for k, v in flax.traverse_util.flatten_dict(back, sep="/").items():
        np.testing.assert_array_equal(
            np.asarray(v),
            np.asarray(flax.traverse_util.flatten_dict(jp, sep="/")[k]))

    # a file without some keys keeps the init and says so
    p3 = str(tmp_path / "partial.npz")
    flat = convert.dhbc_state_to_flax(tp)
    np.savez(p3, **{k: v for k, v in flat.items() if "_Conv_14" not in k})
    assert td.npz_normalize_input(p3) is None
    part = td.load_npz_params(fresh, p3)
    assert part["convs.14.weight"] is fresh["convs.14.weight"]
    np.testing.assert_array_equal(part["convs.3.bias"].detach().numpy(),
                                  tp["convs.3.bias"].detach().numpy())


def loss_inputs(rng, n_classes=10):
    feats = rng.randn(2, 8, 8, 16).astype(np.float32)
    labels = rng.randint(0, n_classes + 1, (2, 8, 8)).astype(np.int32)
    head = (rng.randn(16, n_classes) * 0.3).astype(np.float32)
    coords = rng.randn(2, 8, 8, 3).astype(np.float32)
    chead = (rng.randn(16, 3) * 0.1).astype(np.float32)
    cbias = rng.randn(3).astype(np.float32)
    return feats, labels, head, coords, chead, cbias


@pytest.mark.parametrize("cosine", [False, True])
def test_losses_match_jax(cosine):
    rng = np.random.RandomState(6)
    feats, labels, head, coords, chead, cbias = loss_inputs(rng)
    T = torch.from_numpy
    want = float(jd.dhbc_loss(jnp.asarray(feats), jnp.asarray(labels), 10,
                              jnp.asarray(head), cosine=cosine, tau=16.0))
    got = float(td.dhbc_loss(T(feats), T(labels), 10, T(head),
                             cosine=cosine, tau=16.0))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want = float(jd.coord_loss(jnp.asarray(feats), jnp.asarray(labels),
                               jnp.asarray(coords), jnp.asarray(chead),
                               jnp.asarray(cbias)))
    got = float(td.coord_loss(T(feats), T(labels), T(coords), T(chead),
                              T(cbias)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # an all-background batch: 0, not a division by zero
    zero = torch.zeros_like(T(labels))
    assert float(td.dhbc_loss(T(feats), zero, 10, T(head))) == 0.0


def test_cosine_decay_schedule_matches_optax():
    import optax

    js = optax.cosine_decay_schedule(1e-3, 40)
    ts = td.cosine_decay_schedule(1e-3, 40)
    for c in (0, 1, 7, 20, 39, 40, 55):
        # optax evaluates in f32: within its rounding of the initial rate
        np.testing.assert_allclose(ts(c), float(js(c)), rtol=0, atol=1e-9)
    assert ts(0) == 1e-3


# the train step's tolerances: the first step's gradients relative to each
# tensor's largest magnitude; the later steps' losses (Adam's ±lr steps
# on near-zero gradients make the trajectories drift apart slowly)
GRAD_RTOL = 1e-3
LOSS_RTOL = 2e-3


def test_train_step_matches_optax():
    """Three steps with the coordinate auxiliary and the clip (the clip
    active: the global norm is far above 1)."""
    rng = np.random.RandomState(8)
    n_classes = 10
    jm, jp, tm, tp = flax_pair(True)
    d = depth_batch(rng)
    labels = np.where(d < 255, rng.randint(1, n_classes + 1, d.shape),
                      0).astype(np.int32)
    coords = (rng.randn(*d.shape, 3) * 0.3).astype(np.float32)
    heads = ((rng.randn(16, n_classes) * 0.1).astype(np.float32),
             (rng.randn(16, 3) * 0.1).astype(np.float32),
             np.zeros(3, np.float32))
    kw = dict(learning_rate=3e-4, n_classes=n_classes, coord_weight=30.0,
              clip_norm=1.0)
    jstep, jinit = jd.make_train_step(jm, **kw)
    tstep, tinit = td.make_train_step(tm, **kw)

    jh = tuple(jnp.asarray(h) for h in heads)
    th = tuple(torch.from_numpy(h.copy()) for h in heads)
    jdepth, tdepth = jnp.asarray(d[..., None]), to_nchw(d)
    jlab, tlab = jnp.asarray(labels), torch.from_numpy(labels)
    jco, tco = jnp.asarray(coords), torch.from_numpy(coords)
    jopt, topt = jinit(jp, jh), tinit(tp, th)

    # the first step's gradients, elementwise
    def jloss(p, h):
        f = jm.apply(p, jdepth)
        return (jd.dhbc_loss(f, jlab, n_classes, h[0])
                + 30.0 * jd.coord_loss(f, jlab, jco, h[1], h[2]))

    jl, (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jh)
    tf = torch.func.functional_call(tm, tp, (tdepth,)).permute(0, 2, 3, 1)
    tl = (td.dhbc_loss(tf, tlab, n_classes, th[0])
          + 30.0 * td.coord_loss(tf, tlab, tco, th[1], th[2]))
    grads = torch.autograd.grad(tl, list(tp.values()) + list(th))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = flax.traverse_util.flatten_dict(jgp, sep="/")
    jgrads = [jflat[convert.dhbc_flax_key(k)] for k in tp] + list(jgh)
    gnorm = np.sqrt(sum(float(jnp.sum(g * g)) for g in jgrads))
    assert gnorm > 1.0  # the clip acts
    for k, g, jg in zip(list(tp) + ["cls", "coord", "bias"], grads, jgrads):
        jg = np.asarray(jg)
        if jg.ndim == 4:
            jg = jg.transpose(3, 2, 0, 1)
        scale = max(float(np.abs(jg).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)

    jlosses, tlosses = [], []
    for _ in range(3):
        jp, jh, jopt, jl = jstep(jp, jh, jopt, jdepth, jlab, jco)
        tp, th, topt, tl = tstep(tp, th, topt, tdepth, tlab, tco)
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    assert topt.count == 3
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)


def test_fps_matches_jax():
    rng = np.random.RandomState(9)
    pts = rng.randn(500, 3).astype(np.float32)
    pts[100] = pts[7]  # an exact duplicate: the first-max tie-break
    for n, start in ((16, 0), (40, 123)):
        ji, ja = j_fps(jnp.asarray(pts), n, start_idx=start)
        ti, ta = t_fps(torch.from_numpy(pts), n, start_idx=start)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if inspect.isfunction(v) and v.__module__ == mod.__name__}


@pytest.mark.parametrize("pair", ["glmath", "colorcodec"])
def test_numpy_copies_equal_jax(pair):
    """The copies define the same functions with the same bodies, and
    compute the same values."""
    jmod, tmod = {"glmath": (j_glmath, t_glmath),
                  "colorcodec": (j_codec, t_codec)}[pair]
    jf, tf = _public(jmod), _public(tmod)
    assert sorted(jf) == sorted(tf)
    for name in jf:
        assert inspect.getsource(jf[name]) == inspect.getsource(tf[name])
    if pair == "glmath":
        m = t_glmath.lookat([1, 2, 3], [0, 0, 0], [0, 1, 0])
        np.testing.assert_array_equal(m, j_glmath.lookat([1, 2, 3], [0, 0, 0],
                                                         [0, 1, 0]))
        np.testing.assert_array_equal(t_glmath.ortho(-1, 2, -3, 4, 1, 9),
                                      j_glmath.ortho(-1, 2, -3, 4, 1, 9))
    else:
        ids = np.random.RandomState(1).randint(0, 1 << 24, (8, 8))
        img = t_codec.image_int2color(ids)
        np.testing.assert_array_equal(img, j_codec.image_int2color(ids))
        np.testing.assert_array_equal(t_codec.image_color2idx(img), ids)
        np.testing.assert_array_equal(t_codec.distinct_colors(5),
                                      j_codec.distinct_colors(5))


def gate_loop(seed, port=False, steps=600):
    """tests/test_dhbc.py:204-276 (the 48³ blob, 16 regions, 6 views at
    64², batch-1 steps at lr 1e-3) from JAX's ``init_dhbc(seed)``: in JAX,
    or with ``port`` the port's ``make_train_step`` from the same
    parameters on JAX's renders. Returns (first loss, last loss, held-out
    pixel accuracy trained, random init)."""
    from test_dhbc import _blob_mesh

    from dynamicfusion_body_tpu.pipeline.cnn_correspondence import (
        regularize_verts, view_mvps)
    from dynamicfusion_body_tpu.render.raster import render_id

    size, n_classes, n_views = 64, 16, 6
    verts, faces = _blob_mesh()
    idx, _ = j_fps(jnp.asarray(verts), n_classes)
    centers = verts[np.asarray(idx)]
    lab_v = (np.argmin(np.linalg.norm(verts[:, None] - centers[None],
                                      axis=-1), axis=1) + 1).astype(np.int32)
    zn, zf = 1.0, 3.5
    b = zf * zn / (zn - zf)
    a = -b / zn
    reg = regularize_verts(jnp.asarray(verts), jnp.ones(len(verts), bool))
    vl = jnp.asarray(np.concatenate([[0], lab_v]))

    def render(m):
        ids, zwin = render_id(reg, jnp.asarray(faces),
                              jnp.ones(len(faces), bool), jnp.asarray(m),
                              size, size, S=8)
        d8 = jnp.floor(jnp.clip((zf - b / (zwin - a)) / (zf - zn) * 255.0,
                                0, 255))
        return (np.asarray(d8, np.float32),
                np.asarray(jnp.take(vl, ids, axis=0), np.int32))

    data = [render(m) for m in view_mvps(n_views)]
    hd8, hlab = render(view_mvps(2 * n_views)[1])
    jm, jp0 = jd.init_dhbc(seed, size, size)
    head0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                         (16, n_classes)) * 0.1)
    losses = []
    if port:
        tm, _ = td.init_dhbc(0, device="cpu")
        flat = flax.traverse_util.flatten_dict(jp0, sep="/")
        tm.load_state_dict(convert.dhbc_state_from_flax(
            {k: np.asarray(v) for k, v in flat.items()}, device="cpu"))
        p = dict(tm.named_parameters())
        p0 = {k: v.detach().clone() for k, v in p.items()}
        head = torch.from_numpy(head0.copy())
        step, init = td.make_train_step(tm, learning_rate=1e-3,
                                        n_classes=n_classes)
        opt = init(p, head)
        for i in range(steps):
            d8, lab = data[i % n_views]
            p, head, opt, loss = step(p, head, opt,
                                      torch.from_numpy(d8)[None, None],
                                      torch.from_numpy(lab)[None])
            losses.append(float(loss))

        def acc(params):
            with torch.no_grad():
                f = torch.func.functional_call(
                    tm, params, (torch.from_numpy(hd8)[None, None],))
            return (torch.argmax(f[0].permute(1, 2, 0) @ head, -1) + 1
                    ).numpy()

        pred_t, pred_r = acc(p), acc(p0)
    else:
        step, init = jd.make_train_step(jm, learning_rate=1e-3,
                                        n_classes=n_classes)
        jp, head = jp0, jnp.asarray(head0)
        opt = init(jp, head)
        for i in range(steps):
            d8, lab = data[i % n_views]
            jp, head, opt, loss = step(jp, head, opt,
                                       jnp.asarray(d8)[None, :, :, None],
                                       jnp.asarray(lab)[None])
            losses.append(float(loss))

        def acc(params):
            f = jm.apply(params, jnp.asarray(hd8)[None, :, :, None])
            return np.asarray(jnp.argmax(f[0] @ head, -1)) + 1

        pred_t, pred_r = acc(jp), acc(jp0)
    fg = hlab > 0
    return (losses[0], losses[-1], float((pred_t[fg] == hlab[fg]).mean()),
            float((pred_r[fg] == hlab[fg]).mean()))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_dhbc.py --seeds 0 1 2 3
    # [--port]: the JAX test's training loop from JAX's init_dhbc(seed),
    # in JAX or (--port) in the port from the same parameters (a few
    # minutes a run on the CPU)
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    for seed in args.seeds:
        first, last, acc_t, acc_r = gate_loop(seed, args.port)
        print(f"seed {seed} {'port' if args.port else 'jax'}: loss "
              f"{first:.4f} -> {last:.4f} (ratio {last / first:.3f}); "
              f"held-out accuracy trained {acc_t:.4f}, random "
              f"{acc_r:.4f}", flush=True)
