"""Reverse checkpoint migration CLI: npz checkpoint -> reference-stack
weight files, so models trained here deploy in the reference's own code
unchanged.

Dispatches on the output extension:

* ``.pt`` / ``.pth`` / ``.ckpt`` — torch ``state_dict`` (the format the
  reference trainer saves/loads, `sed.py:196-199`). ``--naming v1`` emits
  the `sed.py:82-112` class's keys, ``v2`` the `crnn_lightning.py:41-73`
  keys, ``generic`` a neutral naming that round-trips through
  `apps/import_torch.py`; ``auto`` (default) picks from the checkpoint's
  shape.
* ``.h5`` / ``.hdf5`` — legacy keras-2.2 HDF5 weights for the original
  SEDnet lineage (``model.load_weights`` onto its ``get_model()``); needs
  ``h5py``, not keras.
* ``.keras`` — modern keras full-model file (needs keras).

  python -m sed_crnn_torch.apps.export_weights \\
      --checkpoint runs/fold1/best_fold1.npz --preset timepooled-v1 --out best_fold1.pt
  python -m sed_crnn_torch.apps.export_weights \\
      --checkpoint runs/fold1/best_fold1.npz --preset sednet-dcase-keras --out sednet.h5

The files are the JAX package's `apps/export_weights.py`'s, key for key.
"""

from __future__ import annotations

import argparse

from sed_crnn_torch.core import checkpoint as ckpt_io
from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.models.transplant import (
    resolve_torch_naming,
    save_keras_checkpoint,
    save_torch_checkpoint,
)

_TORCH_EXTS = (".pt", ".pth", ".ckpt")
_KERAS_EXTS = (".h5", ".hdf5", ".keras")


def export_weights(
    checkpoint: str, preset: str, out_path: str, naming: str = "auto"
) -> str:
    """Returns a one-line description of what was written (the path plus
    the resolved torch naming scheme or keras format)."""
    cfg = get_preset(preset).model
    tree, _meta = ckpt_io.load_checkpoint(checkpoint)
    params, state = tree["params"], tree["model_state"]
    if out_path.endswith(_TORCH_EXTS):
        save_torch_checkpoint(out_path, cfg, params, state, naming)
        scheme = resolve_torch_naming(params, naming)
        return f"{out_path} (torch, naming={scheme})"
    if out_path.endswith(_KERAS_EXTS):
        save_keras_checkpoint(out_path, cfg, params, state)
        fmt = ("keras-2 legacy weights" if out_path.endswith((".h5", ".hdf5"))
               else "keras model")
        return f"{out_path} ({fmt})"
    raise ValueError(
        f"unrecognized output extension in {out_path!r}: torch targets use "
        f"{_TORCH_EXTS}, keras targets use {_KERAS_EXTS}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True,
                    help="npz checkpoint (apps/train.py or apps/import_torch.py output)")
    ap.add_argument("--preset", required=True,
                    help="the preset the checkpoint was trained with")
    ap.add_argument("--naming", default="auto",
                    choices=("auto", "v1", "v2", "generic"),
                    help="torch state_dict key scheme (torch targets only)")
    ap.add_argument("--out", required=True,
                    help="output path; format from extension "
                         "(.pt/.pth/.ckpt torch, .h5/.hdf5 legacy keras-2 "
                         "weights, .keras modern keras model)")
    args = ap.parse_args(argv)
    desc = export_weights(args.checkpoint, args.preset, args.out, args.naming)
    print(f"exported {args.checkpoint} -> {desc}")


if __name__ == "__main__":
    main()
