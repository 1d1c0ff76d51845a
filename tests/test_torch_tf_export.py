"""The port's TF SavedModel export (`sed_crnn_torch/models/tf_export.py`,
`apps/export.py --format tf`) against the JAX package's jax2tf SavedModel
and against the port's own serving artifact, on the CPU.

Every preset family at narrowed widths (`tests/test_torch_model.py::
narrowed`): `sednet-dcase` (mel pooling, ``reset_after=False``) and its
binaural, binmul and keras (hard_sigmoid gates) variants, `timepooled-v1`
and the narrowed `timepooled-v2` of `tests/test_export.py::_tiny_cfg`
(time pooling, ``reset_after=True``), with normalization folded in and
not, and a 2-member ensemble. Float32 probabilities within 1e-5 of JAX's
SavedModel and of `ServingArtifact.forward` at batch 2 and 5 (float32
convolutions and products of three frameworks). `timepooled-v2`'s bf16
trunk at full width: the SavedModel's distance from the port's float32
forward is at most 1.25x JAX's own bf16-vs-float32 distance
(`tests/test_torch_bf16.py`'s band). tensorflow is imported in a fixture,
with oneDNN off (its CPU convolutions run in bf16 otherwise), and every
test skips without it.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest

import chip_smoke
from sed_crnn_tpu.apps import export as jax_export_app
from sed_crnn_tpu.core import checkpoint as jax_ckpt
from sed_crnn_tpu.models import export as jax_export
from sed_crnn_tpu.models import get_model as jax_get_model

from sed_crnn_torch.apps import export as export_app
from sed_crnn_torch.core import config as tcfg_mod
from sed_crnn_torch.models.export import export_serving, export_tf_savedmodel, stack_trees
from tests.test_export import _tiny_cfg
from tests.test_torch_bf16 import BAND, _jax_logits
from tests.test_torch_model import narrowed, port_config_of, seeded_tree

ATOL = 1e-5


@pytest.fixture(scope="module")
def tf():
    os.environ.setdefault("TF_ENABLE_ONEDNN_OPTS", "0")
    return pytest.importorskip("tensorflow")


def _configs(name):
    if name == "timepooled-v2":
        jc = _tiny_cfg()
        return jc, port_config_of(jc)
    return narrowed(name)


def _serve(tf, path, x):
    out = tf.saved_model.load(path).signatures["serving_default"](tf.constant(x))
    (probs,) = out.values()
    return probs.numpy()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name,folded", [
    ("sednet-dcase", True), ("sednet-dcase", False), ("sednet-dcase-binaural", True),
    ("sednet-dcase-binmul", False), ("sednet-dcase-keras", True), ("timepooled-v1", False),
    ("timepooled-v2", True),
])
def test_savedmodel_is_jax_and_the_artifact(tf, tmp_path, name, folded):
    jc, tc = _configs(name)
    params, state = seeded_tree(jax_get_model(jc.model), 50)
    feat, T = jc.model.n_mels * jc.model.in_channels, jc.model.seq_len_in
    stats = None
    if folded:
        rng = np.random.default_rng(51)
        stats = (rng.standard_normal(feat).astype(np.float32),
                 (0.5 + rng.random(feat)).astype(np.float32))
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert export_tf_savedmodel(tc, params, state, got_dir, norm_stats=stats) == got_dir
    jax_export.export_tf_savedmodel(jc, params, state, want_dir, norm_stats=stats)
    art = export_serving(tc, params, state, norm_stats=stats, device="cpu")
    for batch in (2, 5):
        x = _x((batch, T, feat), 52 + batch)
        got = _serve(tf, got_dir, x)
        assert got.shape == (batch, jc.model.seq_len_out, jc.model.n_classes)
        np.testing.assert_allclose(got, _serve(tf, want_dir, x), rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, art.forward(x).numpy(), rtol=0, atol=ATOL)


def test_ensemble_is_the_mean_of_its_members(tf, tmp_path):
    jc, tc = _configs("sednet-dcase")
    jm = jax_get_model(jc.model)
    trees = [seeded_tree(jm, s) for s in (60, 61)]
    params = stack_trees([p for p, _ in trees])
    state = stack_trees([s for _, s in trees])
    export_tf_savedmodel(tc, params, state, str(tmp_path / "port"), ensemble_members=2)
    jax_export.export_tf_savedmodel(jc, params, state, str(tmp_path / "jax"),
                                    ensemble_members=2)
    art = export_serving(tc, params, state, ensemble_members=2, device="cpu")
    x = _x((3, jc.model.seq_len_in, jc.model.n_mels), 62)
    got = _serve(tf, str(tmp_path / "port"), x)
    np.testing.assert_allclose(got, _serve(tf, str(tmp_path / "jax"), x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, art.forward(x).numpy(), rtol=0, atol=ATOL)


def test_bf16_trunk_within_band(tf, tmp_path):
    """Full-width timepooled-v2 with its bf16 trunk, on `test_torch_bf16`'s
    weights and input (seed 0)."""
    params, state = chip_smoke.model_tree(tcfg_mod.get_preset("timepooled-v2").model, 0)
    x = chip_smoke.bf16_input(0)
    cfg = tcfg_mod.get_preset("timepooled-v2")
    assert cfg.model.compute_dtype == "bfloat16"
    export_tf_savedmodel(cfg, params, state, str(tmp_path / "bf16"))
    export_tf_savedmodel(cfg, params, state, str(tmp_path / "f32"), compute_dtype="float32")
    got = _serve(tf, str(tmp_path / "bf16"), x)
    f32 = export_serving(cfg, params, state, compute_dtype="float32", device="cpu")
    want = f32.forward(x).numpy()
    np.testing.assert_allclose(_serve(tf, str(tmp_path / "f32"), x), want, rtol=0, atol=ATOL)

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    jax_dist = np.abs(sig(_jax_logits("bfloat16", False, params, state, x))
                      - sig(_jax_logits("float32", False, params, state, x))).max()
    dist = np.abs(got - want).max()
    assert 0.0 < dist <= BAND * jax_dist, (dist, jax_dist)
    bf16 = export_serving(cfg, params, state, device="cpu").forward(x).numpy()
    np.testing.assert_allclose(got, bf16, rtol=0, atol=BAND * jax_dist)


def _cli_case(tmp_path):
    jc, tc = _configs("timepooled-v2")
    params, state = seeded_tree(jax_get_model(jc.model), 70)
    ckpt = jax_ckpt.save_checkpoint(str(tmp_path / "best.npz"),
                                    {"params": params, "model_state": state}, {"epoch": 4})
    cache = tmp_path / "cache"
    cache.mkdir()
    rng = np.random.default_rng(71)
    stats = (rng.standard_normal(jc.model.n_mels).astype(np.float32),
             (0.5 + rng.random(jc.model.n_mels)).astype(np.float32))
    x = np.zeros((4, jc.model.n_mels), np.float32)
    y = np.zeros((4, 1), np.float32)
    np.savez(str(cache / "mbe_mon_fold1.npz"), x, y, x, y, *stats)
    return jc, tc, ckpt, cache


def test_format_tf_cli_is_jax(tf, tmp_path, capsys):
    jc, tc, ckpt, cache = _cli_case(tmp_path)
    common = ["--checkpoint", ckpt, "--stats-from", str(cache), "--format", "tf"]
    jdir, tdir = str(tmp_path / "jax_tf"), str(tmp_path / "port_tf")
    with mock.patch("sed_crnn_tpu.core.config.get_preset", return_value=jc):
        jax_export_app.main([*common, "--out", jdir, "--platforms", "cpu"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with mock.patch.object(export_app, "get_preset", return_value=tc):
        got = export_app.main([*common, "--out", tdir, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert got == {**want, "artifact": tdir}
    assert got["format"] == "tf_saved_model" and got["norm_folded"]
    x = _x((2, jc.model.seq_len_in, jc.model.n_mels), 72)
    np.testing.assert_allclose(_serve(tf, tdir, x), _serve(tf, jdir, x), rtol=0, atol=ATOL)


def test_format_tf_refuses_a_threshold_in_jax_words(tmp_path, capsys):
    jc, tc, ckpt, _ = _cli_case(tmp_path)
    argv = ["--checkpoint", ckpt, "--format", "tf", "--threshold", "0.5"]
    with mock.patch("sed_crnn_tpu.core.config.get_preset", return_value=jc), \
            pytest.raises(SystemExit):
        jax_export_app.main([*argv, "--out", str(tmp_path / "j"), "--platforms", "cpu"])
    want = capsys.readouterr().err.strip().splitlines()[-1]
    with mock.patch.object(export_app, "get_preset", return_value=tc), \
            pytest.raises(SystemExit):
        export_app.main([*argv, "--out", str(tmp_path / "t"), "--device", "cpu"])
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.split(": error: ")[1] == want.split(": error: ")[1]
    assert "--threshold applies to the sedart format only" in got
    assert not os.path.exists(tmp_path / "t")

