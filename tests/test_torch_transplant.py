"""Checkpoint migration (`sed_crnn_torch/models/transplant.py`) against the
JAX package's `models/transplant.py` on the same seeded files, on the CPU.

* Imported trees are bitwise equal (``np.array_equal``, float32 leaves, the
  same tree paths): the mapping is only transposes and permutations. Torch
  sources are the reference's v1 and v2 classes
  (`chip_smoke.reference_model`), raw and Lightning-wrapped; keras sources
  are a legacy keras-2 ``.h5`` and a ``.keras`` file of a narrowed
  ``sednet-dcase-keras``.
* Every ValueError of the JAX module raises in the port with the same
  message.
* Exported torch state dicts have the JAX one's keys in its order, its
  dtypes and its bits, and load with ``strict=True`` into the reference
  classes, bitwise the tensors they came from.
* The port's forward from an imported narrowed v1 / v2 is within 1e-5 of
  the reference class's eval forward (float32 on the CPU); timepooled-v2's
  bf16 trunk from an imported v2 keeps the band of
  `tests/test_torch_bf16.py`: its distance from the float32 forward at most
  1.25 x the JAX package's own.
* Keras runs in a child process that sets ``TF_ENABLE_ONEDNN_OPTS=0``
  before tensorflow loads (oneDNN runs convolutions in bf16 on some hosts)
  and does only what needs keras: it builds the model with the JAX
  package's `build_keras_sednet` (BatchNorm statistics randomized, the
  recurrent kernels halved so that the recurrence is contractive), saves
  the ``.keras`` file and the legacy ``.h5``, runs keras inference, and
  loads ``.keras`` files with both packages (each package's export read by
  the other). The port's forward from the imported tree is within 1e-5 of
  keras inference (the JAX module's own band).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import warnings
import zipfile

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from sed_crnn_tpu.core import config as jcfg_mod
from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.models import transplant as J
from sed_crnn_tpu.nn.layers import Ctx

from sed_crnn_torch.core import checkpoint as ckpt_io
from sed_crnn_torch.core import config as tcfg_mod
from sed_crnn_torch.models import transplant as T
from sed_crnn_torch.models.convert import load_model

REPO = pathlib.Path(__file__).resolve().parents[1]
FORWARD_ATOL = 1e-5
KERAS_ATOL = 1e-5
BF16_BAND = 1.25
# The narrowed keras SEDnet of the child process.
KERAS_NARROW = dict(seq_len_in=64, conv_channels=(8, 8, 8), gru_hidden=(8, 8))


def cfgs(preset: str, **over):
    """(JAX ModelConfig, port ModelConfig) of a preset with ``over`` replaced."""
    j = dataclasses.replace(jcfg_mod.get_preset(preset).model, **over)
    t = dataclasses.replace(tcfg_mod.get_preset(preset).model, **over)
    return j, t


def assert_trees_bitwise(want, got):
    """``got`` (the port's numpy tree) holds ``want``'s paths and bits in
    float32 leaves."""
    lw, lg = list(chip_smoke._leaves(want)), list(chip_smoke._leaves(got))
    assert [p for p, _ in lw] == [p for p, _ in lg]
    for (path, a), (_, b) in zip(lw, lg):
        assert b.dtype == a.dtype == np.float32, path
        assert np.array_equal(a, b), path


def reference_sd(version: str, seed: int, wrap: bool = False, **widths):
    sd = chip_smoke.reference_model(version, seed, **widths).state_dict()
    return {f"model.{k}": v for k, v in sd.items()} if wrap else sd


PRESET = {"v1": "timepooled-v1", "v2": "timepooled-v2"}


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("wrap", [False, True], ids=["raw", "lightning"])
def test_torch_state_dict_tree_is_jax_bitwise(version, wrap):
    sd = reference_sd(version, 3, wrap)
    jc, tc = cfgs(PRESET[version])
    assert_trees_bitwise(J.params_from_torch_state_dict(jc, sd),
                         T.params_from_torch_state_dict(tc, sd))


@pytest.mark.parametrize("kind", ["pt", "ckpt"])
def test_load_torch_checkpoint_files_are_jax_bitwise(tmp_path, kind):
    """A raw state_dict ``.pt`` loads weights-only; a Lightning ``.ckpt``
    with pickled hyper_parameters falls back to a full unpickle, with the
    warning, in both packages."""
    import argparse

    sd = reference_sd("v2", 4)
    path = str(tmp_path / f"model.{kind}")
    if kind == "pt":
        torch.save(sd, path)
    else:
        torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()},
                    "hyper_parameters": argparse.Namespace(lr=1e-3, fold_id=1),
                    "epoch": 17}, path)
    jc, tc = cfgs("timepooled-v2")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = J.load_torch_checkpoint(path, jc)
        got = T.load_torch_checkpoint(path, tc)
    unpickle = [str(w.message) for w in caught if "FULL unpickle" in str(w.message)]
    assert len(unpickle) == (2 if kind == "ckpt" else 0)
    assert_trees_bitwise(want, got)


def keras_modules(model_cfg, seed: int, gru_bias_rows: int = 0):
    """A seeded keras module stream of ``model_cfg``'s shapes (keras gate
    order, HWIO kernels); ``gru_bias_rows`` 2 gives the (2, 3H) bias of a
    reset_after=True keras cell."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    mods, c_in = [], model_cfg.in_channels
    kh, kw = model_cfg.kernel_size
    mel = model_cfg.n_mels
    for c, p in zip(model_cfg.conv_channels, model_cfg.pool):
        mods.append(("conv", [a(kh, kw, c_in, c), a(c)]))
        mods.append(("bn", [1.0 + a(c), a(c), a(c), rng.uniform(0.5, 1.5, c).astype(np.float32)]))
        c_in, mel = c, mel // p
    d = c_in * mel
    for h in model_cfg.gru_hidden:
        bias = a(gru_bias_rows, 3 * h) if gru_bias_rows else a(3 * h)
        mods.append(("bigru", {k: [a(d, 3 * h), a(h, 3 * h), bias] for k in ("fwd", "bwd")}))
        d = 2 * h
    for n in model_cfg.head_dims:
        mods.append(("dense", [a(d, n), a(n)]))
        d = n
    return mods


@pytest.mark.parametrize("preset", ["sednet-dcase-keras", "sednet-dcase"])
def test_keras_module_stream_is_jax_bitwise(preset):
    """The z,r,h -> r,z,n gate reorder and the single bias; onto the sigmoid
    preset both packages warn that keras-2.2.4 trained hard_sigmoid gates."""
    jc, tc = cfgs(preset)
    mods = keras_modules(tc, 5)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = J.params_from_keras_modules(jc, mods)
        got = T.params_from_keras_modules(tc, mods)
    gate = [w for w in caught if "hard_sigmoid" in str(w.message)]
    assert len(gate) == (2 if preset == "sednet-dcase" else 0)
    assert_trees_bitwise(want, got)
    assert "bh" not in got[0]["gru"][0]["fwd"]


def _legacy_h5_without_layer_names(path):
    import h5py

    with h5py.File(path, "w") as f:
        f.create_group("model_weights")
    return path


def _refusal_cases(tmp):
    """name -> function(transplant module, cfgs index 0 JAX / 1 port)."""
    v1 = reference_sd("v1", 6)
    v2 = reference_sd("v2", 6)
    uni = {k: v for k, v in v1.items() if "_reverse" not in k}
    pt = str(tmp / "v1.pt")
    torch.save(v1, pt)
    narrow = dict(conv_channels=(8, 8, 8), gru_hidden=(4, 4))
    keras_tree = T.params_from_keras_modules(cfgs("sednet-dcase-keras", **narrow)[1],
                                             keras_modules(cfgs("sednet-dcase-keras", **narrow)[1], 7))
    v1_tree = T.params_from_torch_state_dict(cfgs("timepooled-v1")[1], v1)
    v2_tree = T.params_from_torch_state_dict(cfgs("timepooled-v2")[1], v2)
    no_names = _legacy_h5_without_layer_names(str(tmp / "keras3.h5"))

    def c(preset, i, **over):
        return cfgs(preset, **over)[i]

    return {
        "preset mismatch": lambda m, i: m.params_from_torch_state_dict(c("timepooled-v1", i), v2),
        "sednet preset, torch file": lambda m, i: m.load_torch_checkpoint(pt, c("sednet-dcase", i)),
        "unidirectional GRU": lambda m, i: m.params_from_torch_state_dict(c("timepooled-v1", i), uni),
        "GRU hidden": lambda m, i: m.params_from_torch_state_dict(
            c("timepooled-v1", i, gru_hidden=(16, 16)), v1),
        "keras reset_after=True bias": lambda m, i: m.params_from_keras_modules(
            c("sednet-dcase-keras", i, **narrow),
            keras_modules(c("sednet-dcase-keras", 1, **narrow), 8, gru_bias_rows=2)),
        "keras onto timepooled": lambda m, i: m.params_from_keras_modules(c("timepooled-v1", i), []),
        "keras conv block": lambda m, i: m.params_from_keras_modules(
            c("sednet-dcase-binaural", i, **narrow),
            keras_modules(c("sednet-dcase-keras", 1, **narrow), 9)),
        "keras GRU count": lambda m, i: m.params_from_keras_modules(
            c("sednet-dcase-keras", i, **narrow),
            [mod for mod in keras_modules(c("sednet-dcase-keras", 1, **narrow), 9)
             if mod[0] != "bigru"]),
        "legacy h5 without layer_names": lambda m, i: m.load_keras_h5(
            no_names, c("sednet-dcase-keras", i)),
        "unrecognized keras layer": lambda m, i: m._classify_weight_group(
            ["w:0"], [np.zeros((2, 2, 2), np.float32)]),
        "bidirectional weight count": lambda m, i: m._classify_weight_group(
            ["forward_gru/kernel:0", "backward_gru/kernel:0"], [np.zeros((2, 2))] * 2),
        "unknown naming": lambda m, i: m.resolve_torch_naming(v1_tree[0], "v3"),
        "naming v1 of v2": lambda m, i: m.torch_state_dict_from_params(
            c("timepooled-v2", i), *v2_tree, naming="v1"),
        "naming v2 of v1": lambda m, i: m.torch_state_dict_from_params(
            c("timepooled-v1", i), *v1_tree, naming="v2"),
        "torch export of sednet": lambda m, i: m.torch_state_dict_from_params(
            c("sednet-dcase-keras", i, **narrow), *keras_tree),
        "keras export of the torch cell": lambda m, i: m.keras_modules_from_params(*v1_tree),
        "keras export onto timepooled": lambda m, i: m.save_keras_checkpoint(
            str(tmp / "x.h5"), c("timepooled-v1", i), *v1_tree),
        "unknown keras extension": lambda m, i: m.save_keras_checkpoint(
            str(tmp / "x.onnx"), c("sednet-dcase-keras", i, **narrow), *keras_tree),
    }


REFUSALS = ["preset mismatch", "sednet preset, torch file", "unidirectional GRU", "GRU hidden",
            "keras reset_after=True bias", "keras onto timepooled", "keras conv block",
            "keras GRU count", "legacy h5 without layer_names", "unrecognized keras layer",
            "bidirectional weight count", "unknown naming", "naming v1 of v2",
            "naming v2 of v1", "torch export of sednet", "keras export of the torch cell",
            "keras export onto timepooled", "unknown keras extension"]


@pytest.fixture(scope="module")
def refusals(tmp_path_factory):
    cases = _refusal_cases(tmp_path_factory.mktemp("refusals"))
    assert sorted(cases) == sorted(REFUSALS)
    return cases


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_match_jax(refusals, case):
    """Each ValueError of the JAX module, with the same message."""
    fn = refusals[case]
    with pytest.raises(ValueError) as want:
        fn(J, 0)
    with pytest.raises(ValueError) as got:
        fn(T, 1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("version,naming", [("v1", "auto"), ("v1", "v1"), ("v1", "generic"),
                                            ("v2", "auto"), ("v2", "v2"), ("v2", "generic")])
def test_torch_export_is_jax_and_loads_strict(version, naming):
    """The exported state dict: the JAX one's keys in its order, dtypes and
    bits; strict-loads into a fresh reference class, every parameter and
    running statistic bitwise the original (``num_batches_tracked`` is 0,
    int64); the generic naming round-trips to the same tree."""
    sd = reference_sd(version, 10)
    jc, tc = cfgs(PRESET[version])
    params, state = T.params_from_torch_state_dict(tc, sd)
    want = J.torch_state_dict_from_params(jc, params, state, naming)
    got = T.torch_state_dict_from_params(tc, params, state, naming)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype and np.array_equal(got[k], want[k]), k
    if naming == "generic":
        assert_trees_bitwise((params, state), T.params_from_torch_state_dict(tc, got))
        return
    fresh = chip_smoke.reference_model(version, 11)
    fresh.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in got.items()},
                          strict=True)
    back = fresh.state_dict()
    assert list(back) == list(sd)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            assert back[k].dtype == torch.int64 and int(back[k]) == 0
        else:
            assert torch.equal(back[k], v), k


NARROW_REF = {"v1": (dict(conv=8, hidden=(8, 8)), dict(conv_channels=(8, 8, 8), gru_hidden=(8, 8))),
              "v2": (dict(conv=8, hidden=(8, 4)),
                     dict(conv_channels=(8, 8, 8), gru_hidden=(8, 4), compute_dtype="float32"))}


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_forward_from_imported_state_dict_matches_reference_class(version):
    ref_widths, over = NARROW_REF[version]
    ref = chip_smoke.reference_model(version, 12, **ref_widths)
    tc = cfgs(PRESET[version], **over)[1]
    params, state = T.params_from_torch_state_dict(tc, {f"model.{k}": v for k, v in
                                                        ref.state_dict().items()})
    model = load_model({"params": params, "model_state": state}, tc, "cpu")
    x = np.random.default_rng(13).standard_normal((4, 64, 40)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x.transpose(0, 2, 1)[:, None].copy()))
        got, _ = model(torch.from_numpy(x))
    assert got.shape == want.shape == (4, 8, 1)
    err = float((got - want).abs().max())
    assert err <= FORWARD_ATOL, err


def test_imported_v2_bf16_trunk_within_band():
    """timepooled-v2 as the preset serves it (bf16 trunk) from an imported
    full-width v2: the port's distance from its float32 forward is at most
    BF16_BAND x the JAX package's on the same imported tree."""
    sd = reference_sd("v2", 14)
    x = np.random.default_rng(15).standard_normal((8, 64, 40)).astype(np.float32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = cfgs("timepooled-v2", compute_dtype=dtype)
        params, state = T.params_from_torch_state_dict(tc, sd)
        model = load_model({"params": params, "model_state": state}, tc, "cpu")
        with torch.no_grad():
            port = model(torch.from_numpy(x))[0].numpy()
        apply = jax.jit(lambda p, s, v, m=jax_get_model(jc): m.apply(p, s, v, Ctx(train=False))[0])
        out[dtype] = (port, np.asarray(apply(*J.params_from_torch_state_dict(jc, sd), x)))
    port_dist = float(np.abs(out["bfloat16"][0] - out["float32"][0]).max())
    jax_dist = float(np.abs(out["bfloat16"][1] - out["float32"][1]).max())
    assert 0 < port_dist <= BF16_BAND * jax_dist, (port_dist, jax_dist)


# ---------------------------------------------------------------------------
# Keras: one child process does what needs keras
# ---------------------------------------------------------------------------


def _keras_child(out: str) -> None:
    """Build, save and run the narrowed keras SEDnet; load ``.keras`` files
    with both packages. Runs with TF_ENABLE_ONEDNN_OPTS=0 set by the parent."""
    import keras

    from tests.test_keras_import import _legacy_h5_from_keras

    jax.config.update("jax_platforms", "cpu")
    jc, tc = cfgs("sednet-dcase-keras", **KERAS_NARROW)
    kmodel = J.build_keras_sednet(jc)
    rng = np.random.default_rng(16)
    for layer in kmodel.layers:
        kind = type(layer).__name__
        if kind == "BatchNormalization":
            c = layer.get_weights()[0].shape[0]
            layer.set_weights([rng.uniform(0.5, 1.5, c).astype(np.float32),
                               (0.1 * rng.standard_normal(c)).astype(np.float32),
                               (0.1 * rng.standard_normal(c)).astype(np.float32),
                               rng.uniform(0.5, 1.5, c).astype(np.float32)])
        elif kind == "Bidirectional":
            for sub in (layer.forward_layer, layer.backward_layer):
                k, r, b = sub.get_weights()
                sub.set_weights([k, 0.5 * r, b])
    path = os.path.join(out, "sednet.keras")
    kmodel.save(path)
    _legacy_h5_from_keras(kmodel, os.path.join(out, "sednet_legacy.h5"))
    x = rng.standard_normal((2, tc.seq_len_in, tc.n_mels)).astype(np.float32)
    np.save(os.path.join(out, "x.npy"), x)
    np.save(os.path.join(out, "keras_out.npy"), np.asarray(kmodel(x[..., None], training=False)))

    def save(name, tree):
        ckpt_io.save_checkpoint(os.path.join(out, name), {"params": tree[0], "state": tree[1]})

    port_tree = T.load_keras_checkpoint(path, tc)
    save("jax_keras.npz", J.load_keras_checkpoint(path, jc))
    save("port_keras.npz", port_tree)
    # each package's .keras export, read by the other
    T.save_keras_checkpoint(os.path.join(out, "port_export.keras"), tc, *port_tree)
    save("jax_reads_port_export.npz",
         J.load_keras_checkpoint(os.path.join(out, "port_export.keras"), jc))
    J.save_keras_checkpoint(os.path.join(out, "jax_export.keras"), jc, *port_tree)
    save("port_reads_jax_export.npz",
         T.load_keras_checkpoint(os.path.join(out, "jax_export.keras"), tc))
    assert keras.backend.backend() == "tensorflow"


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    out = tmp_path_factory.mktemp("keras")
    env = {**os.environ, "TF_ENABLE_ONEDNN_OPTS": "0", "KERAS_BACKEND": "tensorflow",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-m", "tests.test_torch_transplant", str(out)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out


def _tree(path):
    tree, _ = ckpt_io.load_checkpoint(str(path))
    return tree["params"], tree["state"]


@pytest.mark.parametrize("source", ["keras file", "legacy h5", "legacy h5 by extension",
                                    "port export read by JAX", "JAX export read by the port"])
def test_keras_trees_are_jax_bitwise(keras_files, source):
    jc, tc = cfgs("sednet-dcase-keras", **KERAS_NARROW)
    h5 = str(keras_files / "sednet_legacy.h5")
    if source == "keras file":
        want, got = _tree(keras_files / "jax_keras.npz"), _tree(keras_files / "port_keras.npz")
    elif source == "legacy h5":
        want, got = J.load_keras_h5(h5, jc), T.load_keras_h5(h5, tc)
    elif source == "legacy h5 by extension":
        want, got = J.load_keras_checkpoint(h5, jc), T.load_keras_checkpoint(h5, tc)
    elif source == "port export read by JAX":
        want = _tree(keras_files / "port_keras.npz")
        got = _tree(keras_files / "jax_reads_port_export.npz")
    else:
        want = _tree(keras_files / "port_keras.npz")
        got = _tree(keras_files / "port_reads_jax_export.npz")
    assert_trees_bitwise(want, got)
    if source.startswith("legacy"):
        # the legacy file holds the .keras file's weights
        assert_trees_bitwise(_tree(keras_files / "port_keras.npz"), got)


def _gate_activations(node) -> list:
    """Every GRU's ``recurrent_activation`` in a keras model config."""
    if isinstance(node, dict):
        own = [node["recurrent_activation"]] if "recurrent_activation" in node else []
        return own + [a for v in node.values() for a in _gate_activations(v)]
    if isinstance(node, list):
        return [a for v in node for a in _gate_activations(v)]
    return []


def test_keras_exports_register_the_jax_activation_name(keras_files):
    """Both packages' ``.keras`` exports name keras-2.2's hard_sigmoid by one
    registered name, so that each package loads the other's files."""
    found = []
    for f in ("port_export.keras", "jax_export.keras"):
        with zipfile.ZipFile(keras_files / f) as z:
            found.append([a["config"] for a in
                          _gate_activations(json.loads(z.read("config.json")))])
    assert found[0] == found[1] == ["sed_crnn_tpu>hard_sigmoid_legacy"] * 4


def test_keras_import_forward_matches_keras_inference(keras_files):
    tc = cfgs("sednet-dcase-keras", **KERAS_NARROW)[1]
    params, state = _tree(keras_files / "port_keras.npz")
    model = load_model({"params": params, "model_state": state}, tc, "cpu")
    x = np.load(keras_files / "x.npy")
    want = np.load(keras_files / "keras_out.npy")
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0].numpy()
    assert got.shape == want.shape == (2, tc.seq_len_in, tc.n_classes)
    err = float(np.abs(got - want).max())
    assert err <= KERAS_ATOL, err


if __name__ == "__main__":
    _keras_child(sys.argv[1])
