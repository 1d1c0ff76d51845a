"""The evaluation slice on the CPU against the JAX package: `window_split`,
the batched eval forward (single and two-member ensemble),
`evaluate_split`'s report (median filter, per-class sweep, class-wise
scores, event scores, dumped event lists) and the evaluation CLI with one
and several JAX-format checkpoints. Narrowed float32 presets as in
`tests/test_torch_model.py`; the JAX side on its XLA GRU scan.

Tolerances: probability rolls within 2e-5 (two frameworks' float32 CPU
convolutions and products); the port's scoring fed JAX's own roll gives
JAX's report, counts and chosen thresholds equal, floats within 1e-6,
``None`` in the same places; dumped event files byte-identical; the CLI's
dumped lists rescored reproduce its event scores within 1e-9.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.apps import evaluate as jax_eval_app
from sed_crnn_tpu.core import checkpoint as jax_ckpt
from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.train import evaluate as jax_eval

from sed_crnn_torch.apps import evaluate as eval_app
from sed_crnn_torch.apps import train as train_app
from sed_crnn_torch.apps.score_events import score_event_lists
from sed_crnn_torch.parallel.mesh import Mesh
from sed_crnn_torch.train import evaluate
from tests.test_torch_model import narrowed, port_model, seeded_tree

PROB_ATOL = 2e-5
FLOAT_ATOL = 1e-6
THRESHOLDS = np.asarray([0.2, 0.35, 0.5, 0.65, 0.8], np.float32)


def _split(n_classes, frames, seed):
    fold = train_app.synthetic_folds(1, frames=2 * frames, seed=seed, n_classes=n_classes)[1]
    return fold["val_x"], fold["val_y"]


def _assert_report_equal(got, want, path="report"):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_report_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_report_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        if math.isnan(want) or math.isinf(want):
            assert str(got) == str(want), path
        else:
            assert abs(got - want) <= FLOAT_ATOL, (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _shape(obj):
    """A report's keys and JSON types, without the values."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__


def _jax_roll(jm, params, state, xw, batch_size, ensemble=False):
    """JAX's flat probability roll as its `evaluate_split` computes it."""
    n = xw.shape[0]
    pad = (-n) % batch_size
    xp = np.concatenate([xw, np.zeros((pad, *xw.shape[1:]), xw.dtype)]) if pad else xw
    return np.array(jax_eval._forward_all(jm, params, state, jnp.asarray(xp), batch_size,
                                           ensemble))[:n]


def test_window_split_matches_jax():
    x, y = _split(6, 1100, 1)
    for seq_in, seq_out in ((256, 256), (64, 8), (100, 25)):
        got, want = evaluate.window_split(x, y, seq_in, seq_out), jax_eval.window_split(
            x, y, seq_in, seq_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].shape[0] == x.shape[0] // seq_in and got[1].shape[1] == seq_out
    np.testing.assert_array_equal(evaluate.DEFAULT_THRESHOLDS, jax_eval.DEFAULT_THRESHOLDS)
    assert evaluate.DEFAULT_THRESHOLDS.dtype == np.float32


@pytest.mark.parametrize("preset,n_classes,frames,batch,seed", [
    ("sednet-dcase", 6, 256 * 5 + 100, 2, 50),  # 5 windows, 3 batches, the last padded
    ("timepooled-v1", 1, 64 * 30 + 30, 16, 53),  # 30 windows, 2 batches
])
def test_evaluate_split_matches_jax(tmp_path, preset, n_classes, frames, batch, seed):
    """Seeds whose reports have events, hits and misses in both presets."""
    jc, tc = narrowed(preset)
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, seed)
    params["head"][-1]["w"] = params["head"][-1]["w"] * 4.0
    x, y = _split(n_classes, frames, 51)
    kw = dict(thresholds=THRESHOLDS, batch_size=batch, median_filter=5)
    want = jax_eval.evaluate_split(jm, params, state, x, y, jc,
                                   dump_events_dir=str(tmp_path / "jax"), **kw)
    assert ("per_class_sweep" in want) == (n_classes > 1)
    assert want["confusion"]["tp"] > 0 and want["confusion"]["fp"] > 0
    assert all(c["n_sys"] > 0 for c in want["class_wise_event"][:1])

    # the forward: the port's probability roll against JAX's
    xw, yw = evaluate.window_split(x, y, tc.model.seq_len_in, tc.model.seq_len_out)
    model = port_model(tc, params, state)
    jroll = _jax_roll(jm, params, state, xw, batch)
    roll = evaluate.forward_probabilities([model.eval()], xw, batch)
    assert roll.shape == jroll.shape == (xw.shape[0], tc.model.seq_len_out, n_classes)
    np.testing.assert_allclose(roll.numpy(), jroll, atol=PROB_ATOL)

    # the scoring: JAX's own roll through the port's scoring gives JAX's report
    flat = torch.from_numpy(jroll.reshape(-1, n_classes))
    got = evaluate.score_rolls(flat, torch.from_numpy(yw.reshape(-1, n_classes)), tc,
                               xw.shape[0], THRESHOLDS, median_filter=5,
                               dump_events_dir=str(tmp_path / "port"))
    _assert_report_equal(got, want)
    assert json.dumps(_shape(got)) == json.dumps(_shape(want))
    for name in ("ref_events.txt", "est_events.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()

    # the whole entry point on the CPU: the same report layout
    own = evaluate.evaluate_split(model, x, y, tc, device="cpu", **kw)
    assert _shape(own) == _shape(want) and own["n_windows"] == want["n_windows"]


def test_ensemble_forward_matches_jax_stack_trees():
    jc, tc = narrowed("sednet-dcase")
    jm = jax_get_model(jc.model)
    trees = [seeded_tree(jm, s) for s in (52, 53)]
    x, y = _split(6, 256 * 3, 54)
    xw, _ = evaluate.window_split(x, y, 256, 256)
    want = _jax_roll(jm, jax_eval.stack_trees([p for p, _ in trees]),
                     jax_eval.stack_trees([s for _, s in trees]), xw, 2, ensemble=True)
    models = [port_model(tc, p, s).eval() for p, s in trees]
    got = evaluate.forward_probabilities(models, xw, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_ATOL)
    # two equal members: their mean is the member, to float32 rounding
    one = evaluate.forward_probabilities(models[:1], xw, 2)
    twice = evaluate.forward_probabilities(models[:1] * 2, xw, 2)
    np.testing.assert_allclose(twice.numpy(), one.numpy(), rtol=0, atol=1e-7)


def test_evaluate_split_refusals():
    jc, tc = narrowed("timepooled-v1")
    model = port_model(tc, *seeded_tree(jax_get_model(jc.model), 55))
    short = (np.zeros((10, 40), np.float32), np.zeros((10, 1), np.float32))
    with pytest.raises(ValueError, match="window"):
        evaluate.evaluate_split(model, *short, tc, device="cpu")
    # data-parallel evaluation refuses a short split as the unsharded one does
    with pytest.raises(ValueError, match="window"):
        evaluate.evaluate_split(model, *short, tc,
                                mesh=Mesh("data", 2, 0, torch.device("cpu"), None))
    with pytest.raises(ValueError, match="at least one"):
        evaluate.evaluate_split([], *short, tc, device="cpu")


def test_evaluate_cli_matches_jax_cli(tmp_path, monkeypatch):
    """One and two JAX-format checkpoints through both CLIs on the same fold
    pack: the same report layout; the port's dumped lists rescored give its
    event scores."""
    jc, tc = narrowed("timepooled-v1")
    monkeypatch.setattr(eval_app, "get_preset", lambda name: tc)
    monkeypatch.setattr(jax_eval_app, "get_preset", lambda name: jc)
    jm = jax_get_model(jc.model)
    paths = []
    for i in range(2):
        params, state = seeded_tree(jm, 60 + i)
        paths.append(jax_ckpt.save_checkpoint(str(tmp_path / f"ck{i}.npz"),
                                              {"params": params, "model_state": state},
                                              {"epoch": i + 1}))
    x, y = _split(1, 64 * 20 + 10, 62)
    np.savez(str(tmp_path / "mbe_mon_fold1.npz"), x, y, x[:640], y[:640])
    base = ["--cache-dir", str(tmp_path), "--fold", "1", "--batch-size", "8", "--preset", "x"]
    for ckpts in (paths[:1], paths):
        tag = len(ckpts)
        dump = str(tmp_path / f"events{tag}")
        args = base + ["--checkpoint", *ckpts, "--dump-events", dump]
        jax_eval_app.main(args + ["--out", str(tmp_path / f"jax{tag}.json")])
        got = eval_app.main(args + ["--out", str(tmp_path / f"port{tag}.json"),
                                    "--device", "cpu"])
        want = json.loads((tmp_path / f"jax{tag}.json").read_text())
        assert json.loads((tmp_path / f"port{tag}.json").read_text()) == json.loads(
            json.dumps(got))
        assert _shape(got) == _shape(want)
        ens = got if tag == 1 else got["ensemble"]
        if tag == 2:
            assert got["n_members"] == 2 and [m["checkpoint_epoch"] for m in got["members"]] \
                == [1, 2]
            assert got["mean_er_1s"] == pytest.approx(np.mean([m["er_1s"] for m in
                                                               got["members"]]))
        overall, _ = score_event_lists(os.path.join(dump, "ref_events.txt"),
                                       os.path.join(dump, "est_events.txt"))
        assert overall["er_event"] == pytest.approx(ens["er_event"], abs=1e-9)
        assert overall["f1_event"] == pytest.approx(ens["f1_event"], abs=1e-9)
    # --data-parallel on the CPU (world size 1): the same report
    args = base + ["--checkpoint", paths[0], "--device", "cpu"]
    assert eval_app.main(args + ["--data-parallel"]) == eval_app.main(args)
