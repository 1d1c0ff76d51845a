"""The port's training modules against the JAX package on the CPU, piece by
piece: BatchNorm and Dropout in train mode, max-pool's gradient on ties, the
init schemes, the losses, Adam with clipping, weight decay and the plateau
schedule, the segment metrics, the window samplers, and the checkpoint-tree
conversion.

Tolerances: float32 elementwise math matches to 1e-6 (1e-5 where a mean
over many elements or a normalization is taken in another order); metric
counts are exact and metric ratios within 1e-6; random draws are compared
by their rules (ranges, rates, determinism), since the two frameworks'
generators differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.data import sampler as jax_sampler
from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.nn import layers as jax_layers
from sed_crnn_tpu.ops import losses as jax_losses
from sed_crnn_tpu.ops import metrics as jax_metrics
from sed_crnn_tpu.train import optim as jax_optim

from sed_crnn_torch.data import sampler
from sed_crnn_torch.models import get_model
from sed_crnn_torch.models.convert import from_jax, opt_state_from_jax, opt_state_to_jax, to_jax
from sed_crnn_torch.nn.gru import GRU
from sed_crnn_torch.nn.layers import BatchNorm2d, Dropout, max_pool2d
from sed_crnn_torch.ops import losses, metrics
from sed_crnn_torch.train import optim
from tests.test_torch_model import narrowed, seeded_tree


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_nhwc, (0, 3, 1, 2))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_jax(dtype):
    rng = np.random.default_rng(0)
    C = 5
    x = (2.0 + 3.0 * rng.standard_normal((4, 6, 7, C))).astype(np.float32)
    params = {"scale": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    state = {"mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    jbn = jax_layers.BatchNorm2d(C, 1e-3, 0.3)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want, want_state = jbn.apply(params, state, jx, jax_layers.Ctx(train=True))

    bn = BatchNorm2d(C, 1e-3, 0.3).train()
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(state["mean"]),
                        "running_var": torch.from_numpy(state["var"])})
    got = bn(_nchw(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=atol)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_state["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want_state["var"], rtol=1e-5)


def test_dropout_rate_scale_and_determinism():
    x = torch.ones(200_000)
    d = Dropout(0.25).train()
    y1 = d(x, torch.Generator().manual_seed(3))
    y2 = d(x, torch.Generator().manual_seed(3))
    assert torch.equal(y1, y2)
    assert set(torch.unique(y1).tolist()) == {0.0, float(np.float32(1.0 / 0.75))}
    assert abs(float((y1 > 0).float().mean()) - 0.75) < 0.005
    assert not torch.equal(y1, d(x, torch.Generator().manual_seed(4)))
    with pytest.raises(ValueError):
        d(x)
    assert torch.equal(d.eval()(x), x) and torch.equal(Dropout(0.0).train()(x), x)


def test_max_pool_gradient_goes_to_the_first_maximum():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 3, (2, 4, 10, 3)).astype(np.float32)   # many ties, NHWC
    g = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jax_layers.max_pool2d(a, (1, 2)) * g))(jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    (max_pool2d(xt, (1, 2)) * _nchw(g)).sum().backward()
    got = xt.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    ties = x[:, :, 0::2] == x[:, :, 1::2]
    assert ties.any() and not got[:, :, 1::2][ties].any()


def test_init_schemes_bounds_orthogonality_and_spread():
    g = torch.Generator().manual_seed(0)
    gru = GRU(20, 8, reset_after=False)
    gru.init_parameters(g, "keras")
    wh = gru.wh.detach()
    torch.testing.assert_close(wh @ wh.T, torch.eye(8), rtol=0, atol=1e-5)
    assert float(gru.wi.detach().abs().max()) <= np.sqrt(6 / (20 + 24))
    assert not bool(gru.bi.any())
    gru = GRU(20, 8, reset_after=True)
    gru.init_parameters(g, "torch")
    for p in (gru.wi, gru.wh, gru.bi, gru.bh):
        assert 0 < float(p.detach().abs().max()) <= 1 / np.sqrt(8)

    # whole models: the torch scheme spreads every leaf as the JAX init does;
    # the keras scheme gives glorot spreads, zero biases and orthonormal wh
    jm = jax_get_model("timepooled-v1")
    jp, _ = jm.init(jax.random.PRNGKey(0))
    model = get_model("timepooled-v1").init_parameters(torch.Generator().manual_seed(1))
    got, _ = to_jax(model.state_dict(), model.cfg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(got)):
        a = np.asarray(a)
        assert a.shape == b.shape, path
        if a.size >= 1000:
            np.testing.assert_allclose(b.std(), a.std(), rtol=0.05, err_msg=str(path))
        assert np.abs(b).max() <= max(np.abs(a).max() * 1.05, 1.0), path
    model = get_model("sednet-dcase").init_parameters(torch.Generator().manual_seed(1))
    got, _ = to_jax(model.state_dict(), model.cfg)
    for conv in got["conv"]:
        kh, kw, cin, cout = conv["w"].shape
        bound = np.sqrt(6.0 / ((cin + cout) * kh * kw))
        np.testing.assert_allclose(conv["w"].std(), bound / np.sqrt(3), rtol=0.05)
        assert np.abs(conv["w"]).max() <= bound and not conv["b"].any()
    for bigru in got["gru"]:
        for d in ("fwd", "bwd"):
            wh = bigru[d]["wh"]
            np.testing.assert_allclose(wh @ wh.T, np.eye(wh.shape[0]), atol=1e-5)
            assert "bh" not in bigru[d] and not bigru[d]["bi"].any()
    again = get_model("sednet-dcase").init_parameters(torch.Generator().manual_seed(1))
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_match_jax(reduction):
    rng = np.random.default_rng(2)
    logits = (4 * rng.standard_normal((3, 7, 2))).astype(np.float32)
    targets = (rng.random((3, 7, 2)) > 0.6).astype(np.float32)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    np.testing.assert_allclose(losses.bce_with_logits(lt, tt, reduction).numpy(),
                               jax_losses.bce_with_logits(logits, targets, reduction),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(losses.focal_bce(lt, tt, 0.3, 1.5, reduction=reduction).numpy(),
                               jax_losses.focal_bce(logits, targets, 0.3, 1.5, reduction=reduction),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        losses.make_loss("mse")


@pytest.mark.parametrize("clip,decay", [(None, 0.0), (1.0, 1e-2)])
def test_adam_clip_decay_and_plateau_match_jax(clip, decay):
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jadam = jax_optim.Adam(1e-2, weight_decay=decay, grad_clip_norm=clip)
    adam = optim.Adam(1e-2, weight_decay=decay, grad_clip_norm=clip)
    jplat, plat = jax_optim.ReduceLROnPlateau(0.5, 1), optim.ReduceLROnPlateau(0.5, 1)
    jstate, jp = jadam.init(params), {k: jnp.asarray(v) for k, v in params.items()}
    state, p = adam.init({k: torch.from_numpy(v) for k, v in params.items()}), \
        {k: torch.from_numpy(v) for k, v in params.items()}
    jps, ps = jplat.init(), plat.init()
    for step, metric in enumerate([1.0, 0.5, 0.6, 0.7, 0.2, 0.3]):
        grads = {k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        jp, jstate = jadam.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp,
                                  jnp.float32(jps.lr_scale))
        p, state = adam.update({k: torch.from_numpy(v) for k, v in grads.items()}, state, p,
                               ps.lr_scale)
        jps, ps = jplat.step(jps, metric), plat.step(ps, metric)
        assert (float(jps.best), int(jps.num_bad), float(jps.lr_scale)) == tuple(ps)
        assert state.step == int(jstate.step) == step + 1
        for k in shapes:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
            # g*g after a clip whose norm is summed in another order: a few ulps
            np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(jstate.nu[k]), rtol=1e-5)
    assert ps.lr_scale < 1.0
    g = {k: torch.from_numpy(v) for k, v in params.items()}
    np.testing.assert_allclose(float(optim.global_norm(g)),
                               float(jax_optim.global_norm(params)), rtol=1e-6)


@pytest.mark.parametrize("n,block", [(120, 10), (127, 10), (53, 43), (8, 43)])
def test_metrics_match_jax_with_ragged_tails(n, block):
    rng = np.random.default_rng(n)
    pred = (rng.random((n, 3)) > 0.7).astype(np.float32)
    y = (rng.random((n, 3)) > 0.6).astype(np.float32)
    pt, yt = torch.from_numpy(pred), torch.from_numpy(y)
    got = metrics.all_scores(pt, yt, block)
    want = jax_metrics.all_scores(jnp.asarray(pred), jnp.asarray(y), block)
    n_valid = n - n // 3
    got_m = metrics.all_scores_masked(pt, yt, block, n_valid)
    want_m = jax_metrics.all_scores_masked(jnp.asarray(pred), jnp.asarray(y), block, n_valid)
    for g, w in ((got, want), (got_m, want_m)):
        assert g.keys() == w.keys()
        for k in ("tn", "fp", "fn", "tp"):
            assert int(g[k]) == int(w[k]), k
        for k in ("f1_frame", "er_frame", "f1_overall_1sec", "er_overall_1sec"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-6, err_msg=k)
    # empty reference: the unguarded ER is NaN (0/0) in both
    z = torch.zeros(20, 2)
    assert np.isnan(float(metrics.er_framewise(z, z)))
    assert np.isnan(float(jax_metrics.er_framewise(jnp.zeros((20, 2)), jnp.zeros((20, 2)))))


def test_windows_equal_given_equal_starts_and_sampling_rules():
    rng = np.random.default_rng(4)
    frames = 700
    mel = rng.standard_normal((frames, 6)).astype(np.float32)
    lab = np.zeros((frames, 2), np.float32)
    lab[100:130, 0] = 1
    lab[400:420, 1] = 1
    spec = sampler.WindowSpec("sequence", 64, 8)
    jspec = jax_sampler.WindowSpec("sequence", 64, 8)
    data = {"mel": torch.from_numpy(mel), "lab": torch.from_numpy(lab), "n_frames": frames}
    jdata = {"mel": jnp.asarray(mel), "lab": jnp.asarray(lab), "n_frames": np.int32(frames)}
    starts = np.array([0, 37, 636, 90])
    x, y = sampler.gather_windows(spec, data, torch.from_numpy(starts))
    jx, jy = jax_sampler.gather_windows(jspec, jdata, jnp.asarray(starts))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    idx = np.arange(8, 14)   # 10 windows: the tail indices are clamped and flagged
    x, y, v = sampler.sweep_batch_from(spec, data, torch.from_numpy(idx))
    jx, jy, jv = jax_sampler.sweep_batch_from(jspec, jdata, jnp.asarray(idx))
    for a, b in ((x, jx), (y, jy), (v, jv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    seq = sampler.SequenceWindowSampler(mel, lab, 64, 8)
    jseq = jax_sampler.SequenceWindowSampler(mel, lab, 64, 8)
    assert (seq.n_windows, seq.steps_per_epoch(4), seq.sweep_steps(4)) == (
        jseq.n_windows, jseq.steps_per_epoch(4), jseq.sweep_steps(4))
    g = torch.Generator().manual_seed(0)
    xb, _ = seq.sample_batch(g, 16)
    assert xb.shape == (16, 64, 6)
    firsts = [int(np.flatnonzero((mel == r.numpy()).all(1))[0]) for r in xb[:, 0]]
    assert all(f % 64 == 0 and f // 64 < seq.n_windows for f in firsts)

    bal = sampler.BalancedWindowSampler(mel, lab, 64, 8, augment=True)
    jbal = jax_sampler.BalancedWindowSampler(mel, lab, 64, 8)
    assert (bal.n_pos, bal.n_neg, bal.steps_per_epoch(8)) == (
        jbal.n_pos, jbal.n_neg, jbal.steps_per_epoch(8))
    starts = sampler._balanced_starts(bal.spec, bal.data, torch.Generator().manual_seed(1), 33)
    _, yb = sampler.gather_windows(bal.spec, bal.data, starts)
    assert starts.shape == (33,) and bool((starts <= frames - 64).all())
    assert bool((yb[0::2].amax(dim=(1, 2)) > 0).all())     # positive-anchored
    assert not bool(yb[1::2].any())                        # clean negatives
    xa = sampler.spec_augment(torch.Generator().manual_seed(2), torch.ones(3, 64, 40))
    zero_rows = (xa == 0).all(dim=2).sum(dim=1)
    zero_cols = (xa == 0).all(dim=1).sum(dim=1)
    assert bool(((zero_rows >= 8) & (zero_rows <= 16)).all())
    assert bool(((zero_cols >= 8) & (zero_cols <= 16)).all())


def _assert_tree_equal(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("preset", ["sednet-dcase", "timepooled-v1"])
def test_to_jax_inverts_from_jax(preset):
    jc, tc = narrowed(preset)
    params, state = seeded_tree(jax_get_model(jc.model), 7)
    got_params, got_state = to_jax(from_jax(params, state, tc.model), tc.model)
    _assert_tree_equal(got_params, params)
    _assert_tree_equal(got_state, state)
    # a params-shaped tree without model_state: Adam's moments
    mu_params, mu_state = to_jax(from_jax(params, None, tc.model), tc.model)
    _assert_tree_equal(mu_params, params)
    assert mu_state is None
    opt = {"step": np.asarray(5, np.int32), "mu": params,
           "nu": jax.tree_util.tree_map(np.abs, params)}
    back = opt_state_from_jax(opt, tc.model)
    assert back["step"] == 5
    _assert_tree_equal(opt_state_to_jax(back["step"], back["mu"], back["nu"], tc.model), opt)
    # the port model takes the state dict as it is
    get_model(dataclasses.replace(tc.model)).load_state_dict(from_jax(params, state, tc.model))
