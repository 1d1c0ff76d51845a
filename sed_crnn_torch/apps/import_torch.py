"""Checkpoint migration CLI: reference-lineage weights -> npz checkpoint.

Converts either a torch/Lightning checkpoint of the reference v1/v2 CRNNs
(`sed.py:82-112`, `crnn_lightning.py:41-73`) or a keras SEDnet checkpoint
(the original lineage, keras 2.2.4 `.h5` or modern `.keras`) into the npz
checkpoint format that both packages read, ready for `apps/infer.py`,
`apps/evaluate.py`, `apps/export.py`, or fine-tuning with
`train.loop.run_fold(resume_from=...)`:

  python -m sed_crnn_torch.apps.import_torch \\
      --torch-ckpt best_model.ckpt --preset timepooled-v2 --out best_fold1.npz
  python -m sed_crnn_torch.apps.import_torch \\
      --keras-ckpt sednet_best.h5 --preset sednet-dcase-keras --out best_fold1.npz

The tree and its metadata are the JAX package's `apps/import_torch.py`'s.
Torch files and legacy keras-2 HDF5 files need no keras; `.keras` files
load through the installed keras.
"""

from __future__ import annotations

import argparse

import numpy as np

from sed_crnn_torch.core import checkpoint as ckpt_io
from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.models import get_model
from sed_crnn_torch.models.convert import from_jax, opt_state_to_jax
from sed_crnn_torch.models.transplant import (
    load_keras_checkpoint,
    load_torch_checkpoint,
)
from sed_crnn_torch.train.optim import Adam


def import_checkpoint(
    torch_ckpt: str, preset: str, out_path: str, source: str = "torch"
) -> str:
    cfg = get_preset(preset)
    loader = load_keras_checkpoint if source == "keras" else load_torch_checkpoint
    params, model_state = loader(torch_ckpt, cfg.model)
    # Fresh optimizer moments: the imported model can be served immediately
    # or fine-tuned from step 0 (torch Adam moments are not transferable
    # across optimizer implementations bit-for-bit, so none are imported).
    adam = Adam(
        learning_rate=cfg.train.learning_rate,
        weight_decay=cfg.train.weight_decay,
        grad_clip_norm=cfg.train.grad_clip_norm,
    )
    tensors = from_jax(params, None, cfg.model)
    opt = adam.init(tensors)
    tree = {
        "params": params,
        "model_state": model_state,
        "opt_state": opt_state_to_jax(opt.step, opt.mu, opt.nu, cfg.model),
        "lr_scale": np.ones((), np.float32),
    }
    meta = {
        "imported_from": torch_ckpt,
        "preset": preset,
        "epoch": 0,
        "n_params": sum(t.numel() for t in tensors.values()),
    }
    return ckpt_io.save_checkpoint(out_path, tree, meta)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--torch-ckpt", help=".pt/.ckpt file (timepooled presets)")
    src.add_argument("--keras-ckpt",
                     help=".h5/.keras SEDnet file (sednet presets; keras-2 "
                          "legacy HDF5 and modern keras files both work)")
    ap.add_argument("--preset", default="timepooled-v2",
                    help="timepooled-v1 | timepooled-v2 for torch sources; "
                         "sednet-dcase-keras (exact keras-2.2.4 hard_sigmoid "
                         "cell) or sednet-dcase[-binaural] for keras sources")
    ap.add_argument("--out", required=True, help="output .npz checkpoint path")
    args = ap.parse_args(argv)
    source = "keras" if args.keras_ckpt else "torch"
    ckpt = args.keras_ckpt or args.torch_ckpt
    path = import_checkpoint(ckpt, args.preset, args.out, source)
    model = get_model(get_preset(args.preset).model)
    print(f"imported {ckpt} -> {path} "
          f"(preset {args.preset}, {model.flat_dim}-dim trunk output)")


if __name__ == "__main__":
    main()
