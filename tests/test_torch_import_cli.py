"""The migration CLIs, `sed_crnn_torch.apps.import_torch` and
`sed_crnn_torch.apps.export_weights`, against the JAX package's on the same
seeded files, on the CPU.

* import: the npz written by both has the same keys, bitwise equal arrays
  of equal dtypes (``params``, ``model_state``, zero Adam moments, step 0,
  ``lr_scale`` 1) and equal metadata, from a raw v1 ``.pt``, a Lightning v2
  ``.ckpt`` (the full-unpickle path) and a legacy keras-2 ``.h5``;
* export: the ``.pt`` written by both has the same keys in the same order
  and bitwise equal tensors; the ``.h5`` the same ``layer_names``, the same
  ``weight_names`` and equal arrays; the refusals are the same;
* importing a torch file and a legacy ``.h5`` through the port leaves
  ``jax``, ``keras``, ``tensorflow`` and ``sed_crnn_tpu`` out of
  ``sys.modules``, and importing the migration modules loads neither
  ``h5py`` nor ``keras``.
"""

import argparse
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from sed_crnn_tpu.apps import export_weights as jax_export
from sed_crnn_tpu.apps import import_torch as jax_import
from sed_crnn_tpu.models import transplant as J

from sed_crnn_torch.apps import export_weights as port_export
from sed_crnn_torch.apps import import_torch as port_import
from sed_crnn_torch.core import checkpoint as ckpt_io
from sed_crnn_torch.core.config import get_preset
from tests.test_torch_transplant import cfgs

REPO = pathlib.Path(__file__).resolve().parents[1]


def _source(tmp, kind: str) -> tuple:
    """(flag, path, preset) of a seeded source checkpoint."""
    if kind == "v1-pt":
        path = str(tmp / "v1.pt")
        torch.save(chip_smoke.reference_model("v1", 20).state_dict(), path)
        return "--torch-ckpt", path, "timepooled-v1"
    if kind == "v2-lightning":
        path = str(tmp / "v2.ckpt")
        sd = chip_smoke.reference_model("v2", 21).state_dict()
        torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()},
                    "hyper_parameters": argparse.Namespace(lr=1e-3, fold_id=1),
                    "epoch": 17}, path)
        return "--torch-ckpt", path, "timepooled-v2"
    path = str(tmp / "sednet_legacy.h5")
    jc = cfgs("sednet-dcase-keras")[0]
    J.save_keras_h5_weights(path, *chip_smoke.model_tree(jc, 22))
    return "--keras-ckpt", path, "sednet-dcase-keras"


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("kind", ["v1-pt", "v2-lightning", "keras-h5"])
def test_import_cli_writes_the_jax_checkpoint(tmp_path, capsys, kind):
    flag, src, preset = _source(tmp_path, kind)
    outs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the Lightning file's full-unpickle warning
        for name, app in (("jax", jax_import), ("port", port_import)):
            outs[name] = str(tmp_path / f"{name}.npz")
            app.main([flag, src, "--preset", preset, "--out", outs[name]])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].replace(outs["jax"], "OUT") == printed[1].replace(outs["port"], "OUT")
    want, got = _npz(outs["jax"]), _npz(outs["port"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    tree, meta = ckpt_io.load_checkpoint(outs["port"])
    assert meta == ckpt_io.load_checkpoint(outs["jax"])[1]
    assert meta["epoch"] == 0 and meta["preset"] == preset and meta["imported_from"] == src
    assert int(tree["opt_state"]["step"]) == 0 and float(tree["lr_scale"]) == 1.0
    assert not any(np.any(v) for _, v in chip_smoke._leaves(tree["opt_state"]))


def _trees(tmp, preset: str, seed: int) -> str:
    """A seeded npz checkpoint of ``preset``'s full width."""
    path = str(tmp / f"{preset}.npz")
    params, state = chip_smoke.model_tree(get_preset(preset).model, seed)
    ckpt_io.save_checkpoint(path, {"params": params, "model_state": state}, {"preset": preset})
    return path


@pytest.mark.parametrize("preset,out,naming", [
    ("timepooled-v1", "w.pt", "auto"), ("timepooled-v1", "w.pth", "v1"),
    ("timepooled-v2", "w.pt", "v2"), ("timepooled-v2", "w.ckpt", "generic"),
    ("sednet-dcase-keras", "w.h5", "auto"),
])
def test_export_cli_writes_the_jax_file(tmp_path, capsys, preset, out, naming):
    ckpt = _trees(tmp_path, preset, 23)
    paths = {}
    for name, app in (("jax", jax_export), ("port", port_export)):
        (tmp_path / name).mkdir()
        paths[name] = str(tmp_path / name / out)
        app.main(["--checkpoint", ckpt, "--preset", preset, "--naming", naming,
                  "--out", paths[name]])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].replace(paths["jax"], "OUT") == printed[1].replace(paths["port"], "OUT")
    if out.endswith(".h5"):
        import h5py

        with h5py.File(paths["jax"], "r") as fw, h5py.File(paths["port"], "r") as fg:
            gw, gg = fw["model_weights"], fg["model_weights"]
            names = list(gw.attrs["layer_names"])
            assert list(gg.attrs["layer_names"]) == names
            for layer in names:
                wn = list(gw[layer].attrs["weight_names"])
                assert list(gg[layer].attrs["weight_names"]) == wn
                for n in wn:
                    a, b = np.asarray(gw[layer][n]), np.asarray(gg[layer][n])
                    assert a.dtype == b.dtype and np.array_equal(a, b), n
        return
    want = torch.load(paths["jax"], map_location="cpu", weights_only=True)
    got = torch.load(paths["port"], map_location="cpu", weights_only=True)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("argv", [
    ["--preset", "timepooled-v1", "--out", "w.onnx"],
    ["--preset", "timepooled-v2", "--naming", "v1", "--out", "w.pt"],
    ["--preset", "timepooled-v1", "--out", "w.keras"],
], ids=["extension", "naming v1 of v2", "keras of the torch cell"])
def test_export_cli_refusals_match_jax(tmp_path, argv):
    ckpt = _trees(tmp_path, argv[1], 24)
    argv = ["--checkpoint", ckpt] + argv[:-1] + [str(tmp_path / argv[-1])]
    with pytest.raises(ValueError) as want:
        jax_export.main(argv)
    with pytest.raises(ValueError) as got:
        port_export.main(argv)
    assert str(got.value) == str(want.value)


def test_cli_parsers_refuse_like_jax(capsys):
    """Unknown naming and two sources at once: argparse exits 2 in both."""
    for app in (jax_export, port_export):
        with pytest.raises(SystemExit) as e:
            app.main(["--checkpoint", "c.npz", "--preset", "timepooled-v1", "--naming", "v3",
                      "--out", "w.pt"])
        assert e.value.code == 2
    for app in (jax_import, port_import):
        with pytest.raises(SystemExit) as e:
            app.main(["--torch-ckpt", "a.pt", "--keras-ckpt", "b.h5", "--out", "o.npz"])
        assert e.value.code == 2
    capsys.readouterr()


_CHILD = """
import sys
import sed_crnn_torch.apps.export_weights, sed_crnn_torch.apps.import_torch as app
import sed_crnn_torch.models.transplant
assert not {"h5py", "keras"} & set(sys.modules), "imported at module load"
app.main(["--torch-ckpt", sys.argv[1], "--preset", "timepooled-v1", "--out", sys.argv[3]])
app.main(["--keras-ckpt", sys.argv[2], "--preset", "sednet-dcase-keras", "--out", sys.argv[4]])
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "keras", "tensorflow", "sed_crnn_tpu")))
"""


def test_import_needs_neither_jax_nor_keras(tmp_path):
    pt = _source(tmp_path, "v1-pt")[1]
    h5 = _source(tmp_path, "keras-h5")[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, pt, h5, str(tmp_path / "a.npz"), str(tmp_path / "b.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    assert os.path.exists(tmp_path / "a.npz") and os.path.exists(tmp_path / "b.npz")
