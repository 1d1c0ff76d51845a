"""The training slice end to end on the CPU, against the JAX package on the
same weights and data: one train step of narrowed presets (loss, Adam's
moments, BatchNorm statistics and updated parameters), the deterministic
full-split validation sweep, `run_fold` with JAX-format checkpoints and
resume, and the training CLI. Narrowed configurations as in
`tests/test_torch_model.py` (conv 8, GRU 8); the JAX side runs its XLA GRU
scan.

Tolerances: loss within 1e-5 relative; Adam's moments (the gradient, scaled)
within 1e-5 of each leaf's largest magnitude (float32 convolutions and
products summed in another order); parameters after the step within 1e-6
where the gradient is clear of that noise (Adam's first step moves every
element by about lr * sign(g), whatever |g| is); conv biases ahead of a
train-mode BatchNorm, whose exact gradient is 0, held to rounding noise
below 1e-5 of the tree's largest gradient; BatchNorm running
means within 1e-6 and variances within 1e-5 relative (the single-pass
variance cancels); validation scores equal for counts and within 1e-6
for ratios on weights whose probabilities keep clear of the 0.5 threshold.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.core import checkpoint as jax_ckpt
from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.nn.layers import Ctx
from sed_crnn_tpu.ops.losses import make_loss as jax_make_loss
from sed_crnn_tpu.train import loop as jax_loop
from sed_crnn_tpu.train.optim import Adam as JaxAdam

from sed_crnn_torch.apps import train as train_app
from sed_crnn_torch.apps.infer import load_model
from sed_crnn_torch.core import checkpoint as port_ckpt
from sed_crnn_torch.models.convert import to_jax
from sed_crnn_torch.train import loop
from tests.test_torch_model import narrowed, port_model, seeded_tree

LR = 1e-3


def _narrowed(preset, **train):
    jc, tc = narrowed(preset, dropout=0.0)
    if train:
        jc = jc.replace(train=dataclasses.replace(jc.train, **train))
        tc = tc.replace(train=dataclasses.replace(tc.train, **train))
    return jc, tc


def _max_abs(tree):
    return [float(np.abs(a).max()) for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("preset", ["sednet-dcase", "timepooled-v1"])
def test_one_train_step_matches_jax(preset):
    jc, tc = _narrowed(preset)
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, 40)
    rng = np.random.default_rng(41)
    x = rng.standard_normal((3, jc.model.seq_len_in, 40)).astype(np.float32)
    y = (rng.random((3, jm.seq_len_out, jc.model.n_classes)) > 0.7).astype(np.float32)

    loss_fn = jax_make_loss("bce")

    def loss_of(p):
        logits, new_state, _ = jm.apply(p, state, jnp.asarray(x), Ctx(train=True))
        return loss_fn(logits, jnp.asarray(y)), new_state

    (want_loss, want_state), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    adam = JaxAdam(LR)
    want_params, want_opt = jax.jit(adam.update)(grads, adam.init(params), params,
                                                 jnp.float32(1.0))

    model = port_model(tc, params, state)
    trainer = loop.Trainer(model, dataclasses.replace(tc.train, learning_rate=LR), None, None)
    st = loop.TrainState(trainer.adam.init({k: p.detach() for k, p in trainer.params().items()}),
                         1.0)
    st, loss, probs = trainer.train_step(st, torch.from_numpy(x), torch.from_numpy(y))
    assert probs.shape == y.shape and st.opt_state.step == 1
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)

    tree = loop.checkpoint_tree(trainer, st)
    for g, w in zip(tree["model_state"]["bn"], want_state["bn"]):
        np.testing.assert_allclose(g["mean"], np.asarray(w["mean"]), atol=1e-6)
        # E[x^2] - E[x]^2 cancels, so its summation order shows at ~1e-6
        np.testing.assert_allclose(g["var"], np.asarray(w["var"]), rtol=1e-5)
    mu_scale = max(_max_abs(want_opt.mu))
    leaves = zip(jax.tree_util.tree_leaves_with_path(want_opt.mu),
                 *(jax.tree_util.tree_leaves(t) for t in (
                     tree["opt_state"]["mu"], tree["opt_state"]["nu"], want_opt.nu,
                     tree["params"], want_params)))
    for (path, w_mu), mu, nu, w_nu, p, w_p in leaves:
        name = jax.tree_util.keystr(path)
        w_mu, w_nu, w_p = np.asarray(w_mu), np.asarray(w_nu), np.asarray(w_p)
        np.testing.assert_allclose(p, w_p, atol=2 * LR + 1e-6, err_msg=name)
        if name.startswith("['conv']") and name.endswith("['b']"):
            # A conv bias ahead of a train-mode BatchNorm: its exact gradient
            # is 0 (the batch mean removes any per-channel shift), so both
            # sides hold rounding noise, far below the tree's scale.
            assert max(np.abs(mu).max(), np.abs(w_mu).max()) <= 1e-5 * mu_scale, name
            continue
        scale = float(np.abs(w_mu).max())
        np.testing.assert_allclose(mu, w_mu, rtol=0, atol=1e-5 * scale, err_msg=name)
        np.testing.assert_allclose(nu, w_nu, rtol=0, atol=2e-5 * float(w_nu.max()), err_msg=name)
        clear = np.abs(w_mu) > 1e-4 * scale
        np.testing.assert_allclose(p[clear], w_p[clear], atol=1e-6, err_msg=name)


def _decisive_tree(jm, seed):
    """Seeded weights with a scaled last layer, so that few probabilities
    sit near the 0.5 threshold."""
    params, state = seeded_tree(jm, seed)
    params["head"][-1]["w"] = params["head"][-1]["w"] * 8.0
    return params, state


def test_eval_sweep_scores_match_jax():
    jc, tc = _narrowed("sednet-dcase", batch_size=2)
    folds = train_app.synthetic_folds(1, frames=2700, seed=3, n_classes=6)
    jm = jax_get_model(jc.model)
    params, state = _decisive_tree(jm, 42)
    j_tr, j_val = jax_loop.make_samplers(jc, folds[1])
    jtrainer = jax_loop.Trainer(jm, jc.train, j_tr, j_val)
    adam = JaxAdam()
    want = jtrainer.eval_sweep(jax_loop.TrainState(params, state, adam.init(params),
                                                   jnp.float32(1.0)))

    model = port_model(tc, params, state)
    tr, val = loop.make_samplers(tc, folds[1], torch.device("cpu"))
    trainer = loop.Trainer(model, tc.train, tr, val)
    got = trainer.eval_sweep(None)
    assert val.sweep_steps(2) == 3 and val.n_windows == 5   # a ragged last step
    assert got.keys() == want.keys()
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    for k in ("tn", "fp", "fn", "tp"):
        assert int(got[k]) == int(want[k]), k
    for k in ("f1_frame", "er_frame", "f1_overall_1sec", "er_overall_1sec"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def _tiny_cfg(**train):
    _, tc = _narrowed("sednet-dcase", batch_size=4, max_epochs=2, plot_every=0, **train)
    return tc


def _folds():
    return train_app.synthetic_folds(1, frames=1600, seed=5, n_classes=6)


def test_run_fold_checkpoints_serve_in_jax_and_resume(tmp_path):
    cfg = _tiny_cfg()
    folds = _folds()
    res = loop.run_fold(cfg, folds[1], 1, str(tmp_path / "a"), verbose=False, device="cpu")
    assert res.epochs_run == 2 and res.best_checkpoint is not None
    assert set(res.history) == {k for pair in jax_loop._TRACK_KEYS for k in pair[:2]}
    assert all(len(v) == 2 and np.isfinite(v[0]) for k, v in res.history.items()
               if k.startswith("loss"))
    records = [json.loads(ln) for ln in open(tmp_path / "a" / "train_fold1.jsonl")]
    assert [r["epoch"] for r in records] == [1, 2]
    assert {"fold", "epoch_sec", "audio_hours_per_sec", "train", "val", "lr_scale"} <= set(records[0])

    # the last checkpoint is a JAX checkpoint: the JAX model serves it
    last = str(tmp_path / "a" / "last_fold1.npz")
    tree, meta = jax_ckpt.load_checkpoint(last)
    assert meta["epoch"] == 2 and int(tree["opt_state"]["step"]) == 2 * 2
    jc, _ = _narrowed("sednet-dcase")
    x = np.random.default_rng(6).standard_normal((2, 256, 40)).astype(np.float32)
    jm = jax_get_model(jc.model)
    want = jax.jit(lambda p, s: jm.apply(p, s, x, Ctx())[0])(tree["params"], tree["model_state"])
    port_tree, _ = port_ckpt.load_checkpoint(last)
    with torch.no_grad():
        got = load_model(port_tree, cfg.model, "cpu").eval()(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    # one epoch, then a resume for the second, lands where the straight run did
    loop.run_fold(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, max_epochs=1)),
                  folds[1], 1, str(tmp_path / "b"), verbose=False, device="cpu")
    resumed = loop.run_fold(cfg, folds[1], 1, str(tmp_path / "b"), verbose=False,
                            device="cpu", resume_from=str(tmp_path / "b" / "last_fold1.npz"))
    assert resumed.epochs_run == 2 and resumed.history == res.history
    a, _ = port_ckpt.load_checkpoint(last)
    b, _ = port_ckpt.load_checkpoint(str(tmp_path / "b" / "last_fold1.npz"))
    for x1, x2 in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x1, x2)


def test_resume_from_a_jax_checkpoint_reseeds(tmp_path):
    """A JAX-written checkpoint carries a JAX PRNG key that torch cannot
    continue: the port resumes its weights and optimizer, and reseeds."""
    cfg = _tiny_cfg(plateau_factor=0.5)
    jc, _ = _narrowed("sednet-dcase")
    params, state = seeded_tree(jax_get_model(jc.model), 8)
    opt = JaxAdam().init(params)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(
        path,
        {"params": params, "model_state": state,
         "opt_state": {"step": opt.step, "mu": opt.mu, "nu": opt.nu},
         "lr_scale": np.float32(0.5), "rng_key": np.asarray(jax.random.PRNGKey(1))},
        {"epoch": 1, "best_er": 9.0, "no_imp": 0, "key_seed": 123,
         "plateau": {"best": 1.0, "num_bad": 0, "lr_scale": 0.5}},
    )
    res = loop.run_fold(cfg, _folds()[1], 1, str(tmp_path / "r"), verbose=False,
                        device="cpu", resume_from=path)
    assert res.epochs_run == 2
    tree, meta = port_ckpt.load_checkpoint(str(tmp_path / "r" / "last_fold1.npz"))
    assert meta["epoch"] == 2 and int(tree["opt_state"]["step"]) == 2
    assert "torch_rng" in tree and "rng_key" not in tree


def test_train_cli_runs_on_cpu(tmp_path, monkeypatch):
    tc = _tiny_cfg()
    monkeypatch.setattr(train_app, "get_preset", lambda name: tc)
    out = train_app.main(["--preset", "sednet-dcase", "--synthetic", "--folds", "1",
                          "--max-epochs", "1", "--batch-size", "16", "--plot-every", "0",
                          "--art-dir", str(tmp_path), "--device", "cpu"])
    assert len(out["folds"]) == 1 and out["folds"][0].epochs_run == 1
    run = os.listdir(tmp_path)[0]
    assert os.path.exists(tmp_path / run / "fold1" / "last_fold1.npz")
    assert os.path.exists(tmp_path / run / "experiment.jsonl")
    for flag in ("--seed-parallel", "--data-parallel"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            train_app.main(["--synthetic", "--runs", "2", flag, "2", "--device", "cpu"])


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.run_fold(_tiny_cfg(), _folds()[1], 1, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_app.main(["--synthetic", "--art-dir", str(tmp_path)])


def test_checkpoint_tree_round_trips_through_the_model():
    jc, tc = _narrowed("timepooled-v1")
    params, state = seeded_tree(jax_get_model(jc.model), 9)
    model = port_model(tc, params, state)
    got_params, got_state = to_jax(model.state_dict(), tc.model)
    for a, b in zip(jax.tree_util.tree_leaves((got_params, got_state)),
                    jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(a, b)
