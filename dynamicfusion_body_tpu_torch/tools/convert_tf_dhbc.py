"""Convert the reference's TF1 DHBC checkpoint to the DHBC npz that both
packages load — the port of ``tools/convert_tf_dhbc.py``.

The reference restores an external checkpoint (core/sdf.py:85-93,
core/models/README.txt: core/models/model.{index,meta,data-...}) via
``tf.train.Saver(dhbc.feat_vars)``. Those variables are the slim-named
conv weights of core/net.py:15-56 (7 encoder convs
``feature/encoder/Conv{,_1..._6}``, 8 decoder convs
``feature/decoder/Conv{,_1..._7}``, each ``weights`` and ``biases``).
slim kernels are HWIO, as are the npz's Flax paths
``params/_Conv_i/Conv_0/kernel|bias`` (call order: encoder 0-6, decoder
7-14), so the conversion is a renaming; ``models/dhbc.py:load_npz_params``
transposes the kernels to the port's OIHW on load (``convert.py``).

The expected names and shapes are the manifest ``dhbc_tf_manifest.json``
beside this file (a copy of ``tools/dhbc_tf_manifest.json``), asserted
here: a checkpoint whose variables do not match the reference topology
fails instead of converting garbage.

Usage (tensorflow is needed ONLY to read the checkpoint):

    python -m dynamicfusion_body_tpu_torch.tools.convert_tf_dhbc \\
        --checkpoint core/models/model --out data/dhbc_reference.npz

then ``Fusion(..., use_cnn=True, cnn_weights='data/dhbc_reference.npz')``
(the npz records the reference's raw 0..255 input contract, so
``normalize_input`` resolves to False). ``convert_var_dict`` is the pure
core (TF names → arrays in, Flax paths → arrays out), testable without
tensorflow or the checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

MANIFEST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "dhbc_tf_manifest.json")

# TF scope order → Flax call order (models/dhbc.py DHBC.forward): encoder
# Conv..Conv_6 = _Conv_0.._Conv_6, decoder Conv..Conv_7 = _Conv_7.._Conv_14
_TF_ORDER = [f"feature/encoder/Conv{'' if i == 0 else f'_{i}'}"
             for i in range(7)]
_TF_ORDER += [f"feature/decoder/Conv{'' if i == 0 else f'_{i}'}"
              for i in range(8)]


def load_manifest() -> dict:
    with open(MANIFEST_PATH) as f:
        return json.load(f)


def convert_var_dict(tf_vars: dict) -> dict:
    """TF-name → array dict in, Flax-path → array dict out (npz-ready,
    with the contract markers). Asserts names and shapes against the
    manifest."""
    manifest = load_manifest()
    missing = [n for n in manifest if n not in tf_vars]
    if missing:
        raise ValueError(
            f"checkpoint is missing {len(missing)} expected variables "
            f"(first: {missing[:3]}) — not a DHBC feature checkpoint?"
        )
    out = {
        # the reference feeds raw 0..255 depth (core/sdf.py:135-136) and
        # matches raw (unnormalized) descriptors — record both contracts
        "__normalize_input__": np.bool_(False),
        "__feature_norm__": np.bool_(False),
    }
    for i, scope in enumerate(_TF_ORDER):
        for tf_leaf, flax_leaf in (("weights", "kernel"), ("biases", "bias")):
            name = f"{scope}/{tf_leaf}"
            arr = np.asarray(tf_vars[name], dtype=np.float32)
            want = tuple(manifest[name])
            if arr.shape != want:
                raise ValueError(
                    f"{name}: shape {arr.shape} != expected {want} — "
                    "checkpoint topology differs from core/net.py:15-56"
                )
            out[f"params/_Conv_{i}/Conv_0/{flax_leaf}"] = arr
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="TF checkpoint prefix (e.g. core/models/model)")
    ap.add_argument("--out", required=True, help="output .npz path")
    args = ap.parse_args(argv)

    try:
        import tensorflow as tf  # only needed to READ the checkpoint
    except ImportError:
        sys.exit(
            "tensorflow is required to read the checkpoint (pip install "
            "tensorflow, any 1.x/2.x — tf.train.load_checkpoint reads TF1 "
            "bundles). The conversion itself is TF-free; see "
            "convert_var_dict."
        )
    reader = tf.train.load_checkpoint(args.checkpoint)
    tf_vars = {n: reader.get_tensor(n) for n in load_manifest()}
    out = convert_var_dict(tf_vars)
    np.savez(args.out, **out)
    print(f"wrote {args.out}: {len(out) - 2} arrays "
          f"(+ input/feature contract markers)")
    return args.out


if __name__ == "__main__":
    main()
