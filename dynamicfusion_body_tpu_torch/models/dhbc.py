"""DHBC dense-human-body-correspondence feature network — counterpart of
``dynamicfusion_body_tpu/models/dhbc.py`` (Flax).

Topology of the reference's TF1/slim graph (core/net.py:15-56): an
AlexNet-ish encoder (96/11/s4 → 256/5 → 384/384/256 → two 4096 1x1 convs,
3x3 max pools between stages) and a skip-connected nearest-upsampling
decoder ending in a 16-channel feature map at input resolution. Every
convolution is followed by ELU and pads (k−1)//2 zeros on each side; the
pools pad one ZERO on each side and pool VALID, as the JAX module's
``_maxpool`` does — ELU outputs reach −1, so a −∞-padded pool would give
other border values.

The module works in NCHW: (B,1,H,W) depth8 in, (B,16,H,W) out. Its
convolutions sit in ``self.convs`` in Flax's call order, so ``convs[i]``
is Flax's ``_Conv_i``; the npz weights format (``params/_Conv_{i}/Conv_0/
kernel|bias``, HWIO kernels) is the JAX package's, and weights move both
ways through ``convert.dhbc_state_from_flax``/``dhbc_state_to_flax``.

Parameters travel as a dict ``{state_dict key: tensor}`` (``init_dhbc``
returns the module's own), and callers run the network with
``torch.func.functional_call(model, params, (x,))``, so replacing a
parameter dict works as replacing a Flax pytree does. Training
(``make_train_step``) updates that dict's tensors in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import dhbc_flax_key, dhbc_state_from_flax, dhbc_state_to_flax

# (in channels, out channels, kernel, stride) of the 15 convolutions in
# Flax's call order: encoder 0-6, decoder 7-14 (7, 9, 11, 13, 14 after an
# upsampling; 8, 10, 12 on the [up, skip] concatenation)
CONVS = (
    (1, 96, 11, 4), (96, 256, 5, 1), (256, 384, 3, 1), (384, 384, 3, 1),
    (384, 256, 3, 1), (256, 4096, 1, 1), (4096, 4096, 1, 1),
    (4096, 256, 3, 1), (512, 256, 3, 1), (256, 256, 3, 1), (512, 256, 3, 1),
    (256, 96, 3, 1), (192, 96, 3, 1), (96, 48, 3, 1), (48, 16, 3, 1),
)


def _maxpool(x):
    """3x3/s2 max pool over one zero of padding (``dhbc.py:_maxpool``)."""
    return F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)


def _upsample_nn(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class DHBC(nn.Module):
    """Input (B,1,H,W) depth8 (0..255 floats, the reference's feed format,
    core/sdf.py:135-136); output (B,16,H,W) descriptors.

    ``normalize_input`` rescales to [-0.5, 0.5] inside the module (the
    JAX module's contract: training from scratch needs unit-scale
    inputs; a converted reference checkpoint was trained on raw 0..255,
    so set it False for one)."""

    def __init__(self, features: int = 16, normalize_input: bool = True):
        super().__init__()
        self.normalize_input = normalize_input
        specs = CONVS[:-1] + ((48, features, 3, 1),)
        self.convs = nn.ModuleList(
            nn.Conv2d(i, o, k, stride=s, padding=(k - 1) // 2)
            for i, o, k, s in specs)

    def _conv(self, i, x):
        return F.elu(self.convs[i](x))

    def forward(self, x):
        if self.normalize_input:
            x = x * (1.0 / 255.0) - 0.5
        conv1 = self._conv(0, x)                 # H/4
        pool1 = _maxpool(conv1)                  # H/8
        conv2 = self._conv(1, pool1)             # H/8
        pool2 = _maxpool(conv2)                  # H/16
        conv3 = self._conv(2, pool2)
        conv4 = self._conv(3, conv3)
        conv5 = self._conv(4, conv4)             # H/16
        pool5 = _maxpool(conv5)                  # H/32
        conv6 = self._conv(5, pool5)
        conv7 = self._conv(6, conv6)             # H/32

        up5 = self._conv(7, _upsample_nn(conv7))                 # H/16
        i5 = self._conv(8, torch.cat([up5, conv5], 1))
        up4 = self._conv(9, _upsample_nn(i5))                    # H/8
        i4 = self._conv(10, torch.cat([up4, conv2], 1))
        up3 = self._conv(11, _upsample_nn(i4))                   # H/4
        i3 = self._conv(12, torch.cat([up3, conv1], 1))
        up2 = self._conv(13, _upsample_nn(i3))                   # H/2
        return self._conv(14, _upsample_nn(up2))                 # H


def init_dhbc(rng_seed: int = 0, h: int = 512, w: int = 512,
              normalize_input: bool = True, device="cuda"):
    """(model, params) with Flax's default initializers, drawn from a
    ``torch.Generator`` seeded with ``rng_seed``: LeCun-normal kernels
    (truncated at two standard deviations, scaled so that the truncated
    variance is 1/fan_in) and zero biases. The draws are not JAX's;
    carry parameters across with ``convert.dhbc_state_from_flax`` to
    compare the packages. ``h`` and ``w`` are the JAX signature's (Flax
    initializes from an example input); the module's weights do not
    depend on them. ``normalize_input=False`` is the reference's raw
    0..255 contract (a converted reference checkpoint)."""
    del h, w
    model = DHBC(normalize_input=normalize_input)
    gen = torch.Generator().manual_seed(int(rng_seed))
    with torch.no_grad():
        for conv in model.convs:
            o, i, kh, kw = conv.weight.shape
            # jax.nn.initializers.lecun_normal: variance_scaling(1, fan_in,
            # truncated_normal), stddev corrected for the truncation
            std = math.sqrt(1.0 / (i * kh * kw)) / 0.87962566103423978
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=gen)
            conv.bias.zero_()
    model = model.to(device)
    return model, dict(model.named_parameters())


def npz_normalize_input(npz_path: str):
    """Input-scale contract recorded in a weights npz (see
    save_npz_params), or None for files without the marker (weights
    converted from the reference TF checkpoint, trained on raw 0..255
    inputs: callers default to False for them)."""
    data = np.load(npz_path)
    if "__normalize_input__" in data.files:
        return bool(data["__normalize_input__"])
    return None


def npz_feature_norm(npz_path: str) -> bool:
    """Whether the weights were trained under the cosine (L2-normalized)
    classifier head, so that matching must compare L2-normalized
    descriptors. False for files without the marker."""
    data = np.load(npz_path)
    if "__feature_norm__" in data.files:
        return bool(data["__feature_norm__"])
    return False


def load_npz_params(params, npz_path: str):
    """``params`` with every tensor the npz holds (by its Flax path,
    ``params/_Conv_{i}/Conv_0/kernel``) replaced: a new dict on the same
    device, keeping each tensor's ``requires_grad``. A missing key keeps
    its tensor, and the JAX package's message is printed."""
    data = np.load(npz_path)
    keys = [dhbc_flax_key(k) for k in params]
    flat = {k: data[k] for k in keys if k in data.files}
    dev = next(iter(params.values())).device
    new = dhbc_state_from_flax(flat, device=dev)
    missing = [k for k in params if k not in new]
    if missing:
        print(f"dhbc: {len(missing)} params not found in {npz_path}, kept init")
    return {k: (new[k].to(p.dtype).requires_grad_(p.requires_grad)
                if k in new else p) for k, p in params.items()}


def save_npz_params(params, npz_path: str, normalize_input: bool = True,
                    feature_norm: bool = False):
    """The weights in the JAX package's npz format, with the contracts they
    were trained with: input scale (``__normalize_input__``) and whether
    matching must compare L2-normalized descriptors
    (``__feature_norm__``)."""
    np.savez(npz_path, __normalize_input__=np.bool_(normalize_input),
             __feature_norm__=np.bool_(feature_norm),
             **dhbc_state_to_flax(params))


# --------------------------------------------------------------------- #
# Training (JAX dhbc.py:176-279): per-pixel correspondence classification
# heads over the feature map, an optional canonical-coordinate readout,
# one Adam over network and heads together.


def dhbc_loss(features, labels, n_classes, head_kernel,
              cosine: bool = False, tau: float = 16.0):
    """features (B,H,W,16); labels (B,H,W) int, 0 = unlabeled (masked);
    head_kernel (16, n_classes). Masked mean cross-entropy. ``cosine``:
    L2-normalized features and class weights scaled by ``tau`` (a cosine
    classifier, training-only scaffolding)."""
    del n_classes  # the head's width
    if cosine:
        f = features / torch.clamp_min(
            torch.linalg.vector_norm(features, dim=-1, keepdim=True), 1e-6)
        w = head_kernel / torch.clamp_min(
            torch.linalg.vector_norm(head_kernel, dim=0, keepdim=True), 1e-6)
        logits = tau * torch.einsum("bhwf,fc->bhwc", f, w)
    else:
        logits = torch.einsum("bhwf,fc->bhwc", features, head_kernel)
    logp = F.log_softmax(logits, dim=-1)
    mask = labels > 0
    lab = torch.clamp_min(labels.long() - 1, 0)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    valid = torch.clamp_min(torch.sum(mask), 1)
    return torch.sum(torch.where(mask, nll, 0.0)) / valid


def coord_loss(features, labels, coords, coord_head, coord_bias):
    """Auxiliary canonical-coordinate regression: a linear readout (16→3)
    of the descriptor must reproduce each foreground pixel's rest-pose
    coordinate (JAX ``dhbc.py:coord_loss``). features (B,H,W,16); labels
    (B,H,W) (0 = background, masked); coords (B,H,W,3). Masked mean
    squared error."""
    pred = torch.einsum("bhwf,fc->bhwc", features, coord_head) + coord_bias
    mask = labels > 0
    se = torch.sum((pred - coords) ** 2, dim=-1)
    valid = torch.clamp_min(torch.sum(mask), 1)
    return torch.sum(torch.where(mask, se, 0.0)) / valid


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax's ``cosine_decay_schedule``: the rate at update ``count``
    (step 0 takes the full rate)."""

    def schedule(count):
        c = min(count, decay_steps)
        decayed = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * decayed + alpha)

    return schedule


class _OptState:
    """The optimizer over (network, heads) and its update count."""

    def __init__(self, leaves, lr0):
        self.leaves = leaves
        self.adam = torch.optim.Adam(leaves, lr=lr0)
        self.count = 0


def make_train_step(model, learning_rate=1e-4, n_classes=500,
                    cosine: bool = False, tau: float = 16.0,
                    coord_weight: float = 0.0,
                    clip_norm: float | None = None):
    """(step, init_opt), as JAX's ``make_train_step``.

    ``step(params, head, opt_state, depth, labels, coords=None)`` →
    ``(params, head, opt_state, loss)``: one Adam update of the network
    parameters and the head together (``opt_state = init_opt(params,
    head)`` holds these very tensors and updates them in place, so a
    caller that keeps older parameters keeps copies). ``depth`` is
    (B,1,H,W); ``labels`` (B,H,W); ``coords`` (B,H,W,3). With
    ``coord_weight > 0`` the head is ``(cls (16,C), coord (16,3), bias
    (3,))``. ``learning_rate`` is a float or a schedule of the update
    count (:func:`cosine_decay_schedule`). ``clip_norm`` is optax's
    ``clip_by_global_norm``: gradients scale by ``max_norm / g_norm``
    when their global norm exceeds it."""
    schedule = (learning_rate if callable(learning_rate)
                else (lambda _count: learning_rate))

    def loss_fn(params, head, depth, labels, coords=None):
        feats = torch.func.functional_call(model, params, (depth,))
        feats = feats.permute(0, 2, 3, 1)
        if coord_weight > 0.0:
            cls_head, chead, cbias = head
            ce = dhbc_loss(feats, labels, n_classes, cls_head,
                           cosine=cosine, tau=tau)
            return ce + coord_weight * coord_loss(feats, labels, coords,
                                                  chead, cbias)
        return dhbc_loss(feats, labels, n_classes, head, cosine=cosine,
                         tau=tau)

    def step(params, head, opt_state, depth, labels, coords=None):
        loss = loss_fn(params, head, depth, labels, coords)
        grads = torch.autograd.grad(loss, opt_state.leaves)
        if clip_norm:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < clip_norm
            grads = [torch.where(keep, g, (g / g_norm) * clip_norm)
                     for g in grads]
        for leaf, g in zip(opt_state.leaves, grads):
            leaf.grad = g
        for group in opt_state.adam.param_groups:
            group["lr"] = schedule(opt_state.count)
        opt_state.adam.step()
        opt_state.count += 1
        return params, head, opt_state, loss.detach()

    def init_opt(params, head):
        heads = list(head) if isinstance(head, (tuple, list)) else [head]
        leaves = list(params.values()) + [h.requires_grad_(True)
                                          for h in heads]
        return _OptState(leaves, schedule(0))

    return step, init_opt
