"""Stacked multi-seed training on the CPU: kernel B's stacked plain version,
`StackedCRNN`, the stacked Adam step, `run_fold_multiseed` and
`choose_runs_mode`, against the JAX package and against `run_fold`.

Tolerances:

* the stacked GRU against ``jax.vmap`` of the JAX package's scan
  recurrence: 1e-5 on outputs, 1e-4 of each gradient's largest magnitude;
* `StackedCRNN` train-mode logits (dropout 0, batch statistics) against
  ``jax.vmap`` of ``CRNN.apply`` from JAX's own vmapped init: 2e-5 on
  logits, 1e-5 relative on the losses, 1e-4 of each leaf's largest
  gradient, 1e-5 on the BatchNorm statistics;
* the stacked Adam step against ``jax.vmap`` of JAX's ``Adam.update``:
  1e-6 on parameters, 1e-5 relative on the moments (a clip norm summed in
  another order);
* `run_fold_multiseed` seed s against `run_fold(seed=s)`: the band
  `HISTORY_RTOL` on the loss histories and `HISTORY_ATOL` on the ER/F1
  histories, equal best epochs and epochs run. The two runs compute the same
  function up to float32 rounding (a grouped convolution and batched
  products sum in other orders; `test_stacked_step_matches_separate_steps`
  holds one step to 1e-5), and the bf16 trunk, batch 16 and the focal loss
  carry that rounding into differences of about 1 % in the losses after 36
  steps and into a few flipped frames in the thresholded metrics.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.nn.gru import GRU as JaxGRU
from sed_crnn_tpu.nn.layers import Ctx
from sed_crnn_tpu.ops import losses as jax_losses
from sed_crnn_tpu.train import multiseed as jax_multiseed
from sed_crnn_tpu.train import optim as jax_optim

from sed_crnn_torch.apps import train as train_app
from sed_crnn_torch.core import checkpoint as port_ckpt
from sed_crnn_torch.models.convert import from_jax, to_jax
from sed_crnn_torch.models.stacked import StackedCRNN
from sed_crnn_torch.ops.kernels.gru_scan import GATES, gru_scan_stack
from sed_crnn_torch.ops.losses import make_loss
from sed_crnn_torch.train import loop, multiseed, optim
from tests.test_torch_model import narrowed, port_model

S = 3
HISTORY_RTOL = 0.05
HISTORY_ATOL = 0.1


def _slice(tree, s):
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[s], tree)


# ---- kernel B's stacked plain version ----------------------------------------

@pytest.mark.parametrize("H", [8, 16, 32])
def test_stacked_gru_matches_jax_vmap(H):
    rng = np.random.default_rng(H)
    B, T = 3, 6
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    for reset_after in (False, True):
        for gate in GATES:
            xp = [f32(rng.standard_normal((S, B, T, 3 * H))) for _ in range(2)]
            wh = [f32(0.4 * rng.standard_normal((S, H, 3 * H))) for _ in range(2)]
            bh = [f32(0.1 * rng.standard_normal((S, 3 * H))) for _ in range(2)]
            h0 = [f32(0.5 * rng.standard_normal((S, B, H))) for _ in range(2)]
            dys = [f32(rng.standard_normal((S, B, T, H))) for _ in range(2)]
            dhl = [f32(rng.standard_normal((S, B, H))) for _ in range(2)]

            # JAX: the scan cell on xp itself (wi = I, bi = 0), vmapped over seeds
            cell = JaxGRU(3 * H, H, reset_after, gate, backend="xla")

            def scan(xp_, wh_, bh_, h0_, reverse):
                p = {"wi": jnp.eye(3 * H), "bi": jnp.zeros(3 * H), "wh": wh_}
                if reset_after:
                    p["bh"] = bh_
                return cell.apply(p, xp_, h0_, reverse=reverse)

            def objective(xp_, wh_, bh_, h0_, dys_, dhl_, reverse):
                ys, hl = scan(xp_, wh_, bh_, h0_, reverse)
                return jnp.sum(ys * dys_) + jnp.sum(hl * dhl_), (ys, hl)

            tx = [torch.from_numpy(a).requires_grad_() for a in xp + wh + bh + h0]
            (yf, hf), (yb, hb) = gru_scan_stack(tuple(tx[0:2]), tuple(tx[2:4]),
                                                tuple(tx[4:6]) if reset_after else (None, None),
                                                tuple(tx[6:8]), reset_after, gate)
            loss = sum((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()
                       for y, h, dy, dh in ((yf, hf, dys[0], dhl[0]), (yb, hb, dys[1], dhl[1])))
            loss.backward()
            for d, (ys, hl) in enumerate(((yf, hf), (yb, hb))):
                grads, want = jax.jit(jax.vmap(jax.grad(
                    lambda *a: objective(*a, d == 1), argnums=(0, 1, 2, 3), has_aux=True)))(
                    xp[d], wh[d], bh[d], h0[d], dys[d], dhl[d])
                np.testing.assert_allclose(ys.detach().numpy(), want[0], atol=1e-5)
                np.testing.assert_allclose(hl.detach().numpy(), want[1], atol=1e-5)
                got = [tx[0 + d].grad, tx[2 + d].grad, tx[4 + d].grad, tx[6 + d].grad]
                for name, g, w in zip(("dxp", "dwh", "dbh", "dh0"), got, grads):
                    w = np.asarray(w)
                    if name == "dbh" and not reset_after:
                        assert g is None   # no bh given
                        continue
                    scale = np.abs(w).max()
                    assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, (name, reset_after, gate)


# ---- StackedCRNN -------------------------------------------------------------

def _v2_float32():
    jc, tc = narrowed("timepooled-v2", dropout=0.0, compute_dtype="float32")
    full = dict(conv_channels=(16, 16, 16), gru_hidden=(16, 8))
    return (jc.replace(model=dataclasses.replace(jc.model, **full)),
            tc.replace(model=dataclasses.replace(tc.model, **full)))


@pytest.mark.parametrize("which", ["timepooled-v2", "sednet-dcase"])
def test_stacked_crnn_train_step_matches_jax_vmap(which):
    jc, tc = _v2_float32() if which == "timepooled-v2" else narrowed(which, dropout=0.0)
    jm = jax_get_model(jc.model)
    params, state = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(4), S))
    rng = np.random.default_rng(5)
    B = 4
    x = rng.standard_normal((S, B, jc.model.seq_len_in, jc.model.n_mels)).astype(np.float32)
    y = (rng.random((S, B, jm.seq_len_out, jc.model.n_classes)) > 0.7).astype(np.float32)
    jloss = jax_losses.make_loss(jc.train.loss)

    def objective(p, st, xs, ys):
        logits, new_st, _ = jm.apply(p, st, xs, Ctx(train=True))
        return jloss(logits, ys), (logits, new_st)

    (want_loss, (want_logits, want_state)), want_grads = jax.jit(jax.vmap(
        jax.value_and_grad(objective, has_aux=True)))(params, state, jnp.asarray(x), jnp.asarray(y))

    model = StackedCRNN.from_models(
        [port_model(tc, _slice(params, s), _slice(state, s)) for s in range(S)]).train()
    logits = model(torch.from_numpy(x))
    losses = make_loss(tc.train.loss)(logits, torch.from_numpy(y), reduction="none").mean(
        dim=(1, 2, 3))
    losses.sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=2e-5)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want_loss), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    sd = model.state_dict()
    for s in range(S):
        got_g, _ = to_jax(model.split(grads, s), tc.model)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(_slice(want_grads, s)),
                                jax.tree_util.tree_leaves(got_g)):
            scale = max(np.abs(w).max(), 1e-12)
            if "conv" in str(path) and path[-1].key == "b":
                continue   # a bias ahead of train-mode BatchNorm: its gradient is 0 (noise)
            assert np.abs(g - w).max() <= 1e-4 * scale, (s, path)
        _, got_state = to_jax(model.split(sd, s), tc.model)
        for w, g in zip(jax.tree_util.tree_leaves(_slice(want_state, s)),
                        jax.tree_util.tree_leaves(got_state)):
            np.testing.assert_allclose(g, w, atol=1e-5)
    # seed i comes back as the CRNN it was built from (its parameters; the
    # train-mode forward moved only the BatchNorm statistics)
    back = model.seed(1).state_dict()
    for k, v in from_jax(_slice(params, 1), None, tc.model).items():
        assert torch.equal(back[k], v), k


def test_stacked_adam_matches_jax_vmap():
    rng = np.random.default_rng(6)
    shapes = {"a": (S, 4, 3), "b": (S, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    scales = np.asarray([1.0, 0.5, 0.25], np.float32)
    jadam = jax_optim.Adam(1e-2, weight_decay=1e-4, grad_clip_norm=1.0)
    adam = optim.Adam(1e-2, weight_decay=1e-4, grad_clip_norm=1.0)
    jstate = jax.vmap(jadam.init)(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    state = adam.init(p)
    for step in range(4):
        # seed 0 within the clip, the others well past it
        grads = {k: ((0.01 if step == 0 else 3.0) * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        grads["a"][0] *= 0.01
        jp, jstate = jax.vmap(jadam.update)({k: jnp.asarray(v) for k, v in grads.items()},
                                           jstate, jp, jnp.asarray(scales))
        p, state = adam.update_stacked({k: torch.from_numpy(v) for k, v in grads.items()},
                                       state, p, torch.from_numpy(scales))
        assert state.step == step + 1
        for k in shapes:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
            np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(jstate.nu[k]), rtol=1e-5)
    norms = optim.global_norm({k: torch.from_numpy(v) for k, v in grads.items()}, n_seeds=S)
    np.testing.assert_allclose(norms.numpy(), [float(jax_optim.global_norm(_slice(grads, s)))
                                               for s in range(S)], rtol=1e-6)


# ---- run_fold_multiseed --------------------------------------------------------

def _v2_fold_cfg(**train):
    from sed_crnn_torch.core.config import get_preset

    cfg = get_preset("timepooled-v2")
    fields = dict(batch_size=16, max_epochs=3, plot_every=0, early_stop_patience=1) | train
    return cfg.replace(train=dataclasses.replace(cfg.train, **fields))


@pytest.fixture(scope="module")
def v2_runs(tmp_path_factory):
    """timepooled-v2 at full width (bf16 trunk), batch 16, 3 epochs of 12
    steps, patience 1: stacked over 3 seeds, and run_fold per seed."""
    root = tmp_path_factory.mktemp("v2")
    cfg = _v2_fold_cfg()
    fold = train_app.synthetic_folds(1, frames=800, seed=3, n_classes=1)[1]
    seeds = multiseed.run_seeds(3, S)
    stacked = multiseed.run_fold_multiseed(cfg, fold, 1, str(root / "st"), seeds, verbose=False,
                                           device="cpu")
    alone = [loop.run_fold(cfg, fold, 1, str(root / f"alone{s}"), seed=s, verbose=False,
                           device="cpu") for s in seeds]
    return cfg, fold, seeds, stacked, alone, root


def test_run_fold_multiseed_matches_run_fold(v2_runs):
    cfg, _, seeds, stacked, alone, root = v2_runs
    assert sorted(r.epochs_run for r in alone) == [2, 2, 3]   # two seeds stop early
    for s, got, want in zip(seeds, stacked, alone):
        assert (got.best_epoch, got.epochs_run) == (want.best_epoch, want.epochs_run)
        assert got.history.keys() == want.history.keys()
        for k, v in want.history.items():
            tol = dict(rtol=HISTORY_RTOL) if k.startswith("loss") else dict(atol=HISTORY_ATOL)
            np.testing.assert_allclose(got.history[k], v, **tol, err_msg=k)
        d = root / "st" / f"seed{s}"
        names = set(os.listdir(d))
        assert {"best_fold1.npz", "last_fold1.npz", "train_fold1.jsonl"} <= names
        assert len([n for n in names if n.startswith("epoch")]) == got.epochs_run  # policy "all"
        recs = [json.loads(ln) for ln in open(d / "train_fold1.jsonl")]
        assert [r["epoch"] for r in recs] == list(range(1, got.epochs_run + 1))
        assert set(recs[0]) == {"fold", "seed", "epoch", "epoch_sec", "audio_hours_per_sec",
                                "train", "val", "lr_scale", "time"}
        tree, meta = port_ckpt.load_checkpoint(str(d / "last_fold1.npz"))
        want_tree, want_meta = port_ckpt.load_checkpoint(str(root / f"alone{s}" /
                                                              "last_fold1.npz"))
        assert set(tree) == set(want_tree) and set(want_meta) <= set(meta)
        assert meta["epoch"] == got.epochs_run and meta["history"] == got.history
        assert int(tree["opt_state"]["step"]) == int(want_tree["opt_state"]["step"])
        assert [a.shape for a in tree["torch_rng"]] == [a.shape for a in want_tree["torch_rng"]]


def test_stacked_seed_resumes_in_run_fold(v2_runs, tmp_path):
    cfg, fold, seeds, stacked, alone, root = v2_runs
    i = next(j for j, r in enumerate(stacked) if r.epochs_run == 3)
    s = seeds[i]
    d = root / "st" / f"seed{s}"
    (name,) = [n for n in os.listdir(d) if n.startswith("epoch002")]
    resumed = loop.run_fold(cfg, fold, 1, str(tmp_path), seed=s, verbose=False, device="cpu",
                            resume_from=str(d / name))
    assert resumed.epochs_run == 3
    for k, v in alone[i].history.items():
        tol = dict(rtol=HISTORY_RTOL) if k.startswith("loss") else dict(atol=HISTORY_ATOL)
        np.testing.assert_allclose(resumed.history[k], v, **tol, err_msg=k)
    # epochs 1-2 are the stacked run's own record, epoch 3 continues its chain
    assert resumed.history["loss_tr"][:2] == stacked[i].history["loss_tr"][:2]


def test_stacked_step_matches_separate_steps():
    """One train step of the stacked trainer against a `Trainer` step per
    seed on the same weights and batches, float32 trunk, distinct lr
    scales: losses 1e-6 relative, Adam's first moments (0.1 x the clipped
    gradient) 1e-5 of each leaf's largest (the conv biases ahead of BatchNorm,
    whose gradient is 0, to the tree's scale), parameters 1e-6 where the
    gradient is 100 times clear of that band (Adam's first step moves an element by
    about lr, whatever its gradient)."""
    from sed_crnn_torch.models import get_model

    _, tc = _v2_float32()
    models = [get_model(tc.model).init_parameters(torch.Generator().manual_seed(s))
              for s in range(S)]
    stacked = StackedCRNN.from_models(models)
    trainer = multiseed.MultiSeedTrainer(stacked, tc.train, None, None)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((S, 8, 64, 40)).astype(np.float32))
    y = torch.from_numpy((rng.random((S, 8, 8, 1)) > 0.7).astype(np.float32))
    scales = (1.0, 0.5, 2.0)
    st = loop.TrainState(trainer.adam.init({k: p.detach() for k, p in trainer.params().items()}),
                         torch.tensor(scales))
    st, losses, _ = trainer.train_step(st, x, y)
    for s, (m, scale) in enumerate(zip(models, scales)):
        one = loop.Trainer(m, tc.train, None, None)
        ost = loop.TrainState(one.adam.init({k: p.detach() for k, p in one.params().items()}),
                              scale)
        ost, loss, _ = one.train_step(ost, x[s], y[s])
        np.testing.assert_allclose(float(losses[s]), float(loss), rtol=1e-6)
        got_mu = stacked.split(st.opt_state.mu, s)
        got_p = stacked.split(dict(stacked.named_parameters()), s)
        tree_scale = max(float(v.abs().max()) for v in ost.opt_state.mu.values())
        for k, p in m.named_parameters():
            mu = ost.opt_state.mu[k]
            band = 1e-5 * float(mu.abs().max())
            if k.startswith("conv.") and k.endswith(".bias"):
                # ahead of train-mode BatchNorm its gradient is 0: both hold noise
                assert float((got_mu[k] - mu).abs().max()) <= 1e-5 * tree_scale, k
                continue
            assert float((got_mu[k] - mu).abs().max()) <= band, k
            clear = mu.abs() > 100 * band
            np.testing.assert_allclose(got_p[k].detach()[clear].numpy(),
                                       p.detach()[clear].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_lr_scales_dirs_and_errors(tmp_path):
    cfg = _v2_fold_cfg(max_epochs=1)
    fold = train_app.synthetic_folds(1, frames=800, seed=3, n_classes=1)[1]
    res = multiseed.run_fold_multiseed(cfg, fold, 2, str(tmp_path), [5, 5], verbose=False,
                                       lr_scales=[1.0, 0.5], device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["seed5_lr0.5", "seed5_lr1"]
    assert len(res) == 2 and res[0].history != res[1].history
    _, meta = port_ckpt.load_checkpoint(str(tmp_path / "seed5_lr0.5" / "last_fold2.npz"))
    assert meta["base_lr_scale"] == 0.5 and meta["seed"] == 5
    for kwargs, match in (
        (dict(seeds=[1, 1]), "duplicate seeds"),
        (dict(seeds=[1, 2], lr_scales=[1.0]), "need one per lane"),
        (dict(seeds=[1, 1], lr_scales=[0.5, 0.5]), r"duplicate \(seed, lr_scale\) lanes"),
        (dict(seeds=[]), "at least one seed"),
    ):
        for fn in (multiseed.run_fold_multiseed, jax_multiseed.run_fold_multiseed):
            with pytest.raises(ValueError, match=match):
                fn(cfg, fold, 1, str(tmp_path / "bad"), verbose=False, **kwargs)
    assert not os.path.exists(tmp_path / "bad")


def test_choose_runs_mode_rules(monkeypatch):
    from sed_crnn_torch.core.config import get_preset

    split = multiseed.STACKED_SPLIT_BATCH
    monkeypatch.setattr(jax_multiseed, "BN_FUSION_SPLIT_BATCH", split)
    from sed_crnn_tpu.core.config import get_preset as jax_preset

    for name in ("timepooled-v2", "timepooled-v1", "sednet-dcase", "sednet-dcase-binmul"):
        cfg, jc = get_preset(name), jax_preset(name)
        for n in (1, 2, 3, 4, 5, 8):
            for batch in (16, 128):
                c = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch))
                j = jc.replace(train=dataclasses.replace(jc.train, batch_size=batch))
                got = multiseed.choose_runs_mode(c, n)
                assert got == jax_multiseed.choose_runs_mode(j, n)
                small = max(c.model.conv_channels) < 128
                assert got == ("stacked" if small or batch * n < split else "sequential")
