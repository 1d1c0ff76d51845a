"""Data and seed parallelism of the PyTorch port on the CPU, against the JAX
package: `parallel/mesh.py`, `parallel/data_parallel.py`, cross-replica
BatchNorm, `data/pipeline.py`, `fit_norm_stats(group=)`, sharded
`evaluate_split`, the seed mesh of `run_fold_multiseed` and the parallel
flags of the CLIs.

The multi-rank checks run in one spawn of two gloo ranks (`_two_ranks`,
module-scoped), whose results the tests below read; every spawn and every
wait is bounded. The child imports this module, so JAX is imported inside
the tests only.

Tolerances: the data-parallel gradient of a fixed global batch (two halves
of 16) within 2e-5 of JAX's single-device global-batch gradient (the JAX
package's own band for its data-parallel gradient, `tests/test_parallel.py`)
beyond the port's own single-device gap to it, and within 2e-5 of the
port's single-device gradient of the whole batch. That single-device gap is
bounded here by `SINGLE_DEVICE_JAX_GAP`: it reads 1.05e-4 on one leaf (at
JAX's PRNGKey(0) weights the port's gradient of the first convolution's
output channel 4 misses JAX's by 1.1 % of that leaf's largest entry), with
or without data parallelism; both CPU convolution backends of torch agree
to 5e-8. Its cause is open. A BatchNorm reduction that autograd does not
see misses both by far more.
Cross-replica BatchNorm's output, statistics and running buffers within
1e-5 of JAX's `BatchNorm2d` under `shard_map` with ``axis_name``;
`fit_norm_stats` within 1e-6. Parameters across ranks, sharded evaluation
reports, the seed mesh's per-seed results and prefetched batches: bitwise.
"""

import dataclasses
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sed_crnn_torch.apps import evaluate as eval_app
from sed_crnn_torch.apps import train as train_app
from sed_crnn_torch.core import checkpoint as port_ckpt
from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.data import pipeline
from sed_crnn_torch.models import get_model
from sed_crnn_torch.models.convert import from_jax, to_jax
from sed_crnn_torch.nn.layers import BatchNorm2d
from sed_crnn_torch.ops.frontend import fit_norm_stats
from sed_crnn_torch.parallel import mesh as mesh_mod
from sed_crnn_torch.parallel.data_parallel import DataParallelTrainer, shard_fold_data
from sed_crnn_torch.train import evaluate, loop, multiseed

SPAWN_TIMEOUT_S = 300
GRAD_ATOL = 2e-5
SINGLE_DEVICE_JAX_GAP = 1.2e-4  # the port's one-device gradient to JAX's (reads 1.05e-4)
N_SEEDS = 4


# ---- shared inputs ------------------------------------------------------------


def _v2_cfg(batch=32):
    """timepooled-v2 at float32 with dropout 0 and the BCE loss: the JAX
    test's set-up."""
    cfg = get_preset("timepooled-v2")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dropout=0.0, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=batch, plot_every=0, loss="bce"))


def _fold(seed, frames):
    """One synthetic single-class fold (the JAX DP tests' `_synthetic_fold`)."""
    from sed_crnn_torch.data.rasterize import rasterize_events

    rng = np.random.default_rng(seed)

    def split(n):
        mel = rng.standard_normal((n, 40)).astype(np.float32)
        events, t = [], 2.0
        while t * 43 < n - 100:
            events.append((t, t + 0.3))
            t += 3.0
        lab = rasterize_events(events, n, 44100, 1024)
        mel[lab[:, 0] == 1, 8:16] += 4.0
        return mel, lab

    tr, va = split(frames), split(frames // 2)
    return {"train_x": tr[0], "train_y": tr[1], "val_x": va[0], "val_y": va[1]}


def _seq_cfg():
    """A narrowed sednet-dcase (sequence sampler, full-split sweep)."""
    cfg = get_preset("sednet-dcase")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, conv_channels=(8, 8, 8), gru_hidden=(8, 8),
                                  head_dims=(4, 6), seq_len_in=64, dropout=0.0),
        train=dataclasses.replace(cfg.train, batch_size=8, max_epochs=2, plot_every=0))


def _numpy(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _adversarial(frames=4000):
    """`tests/multihost_child.py`'s layout: every positive frame in the first
    half of the train split (starves host 1), and a val split whose second
    half is all positive (no clean negative window there)."""
    fold = _fold(0, frames)
    train_y = fold["train_y"].copy()
    train_y[frames // 2:] = 0.0
    val_y = np.zeros((frames, 1), np.float32)
    val_y[frames // 2:] = 1.0
    val_y[100:110] = 1.0
    return {"train_x": fold["train_x"], "train_y": train_y,
            "val_x": np.zeros((frames, 40), np.float32), "val_y": val_y}


# ---- the two ranks ----------------------------------------------------------------


def _grads(trainer, x, y):
    """`Trainer.train_step`'s gradient, reduced, without the update."""
    trainer.model.train()
    params = trainer.params()
    with trainer._synced():
        logits, _ = trainer.model(x)
        loss = trainer.loss_fn(logits, y)
        grads = trainer._reduce_grads(torch.autograd.grad(loss, list(params.values())))
    return {k: g.detach().clone() for k, g in zip(params, grads)}


def _ranks(payload):
    torch.set_num_threads(2)
    mesh = mesh_mod.make_mesh(2, device="cpu")
    r, out = mesh.rank, {}
    half = slice(16 * r, 16 * (r + 1))

    # gradient of a fixed global batch, and with a reduction autograd misses
    cfg = _v2_cfg()
    fold = _fold(1, 3000)
    ts, vs = loop.make_samplers(cfg, fold, torch.device("cpu"))
    model = get_model(cfg.model)
    model.load_state_dict(payload["v2_state"])
    trainer = DataParallelTrainer(model, cfg.train, ts, vs, mesh)
    x, y = torch.from_numpy(payload["x"][half]), torch.from_numpy(payload["y"][half])
    out["grads"] = _grads(trainer, x, y)
    out["running"] = _numpy({k: v for k, v in model.state_dict().items() if "running" in k})
    differentiable = mesh_mod.all_reduce_sum_grad
    mesh_mod.all_reduce_sum_grad = mesh_mod.all_reduce_sum
    try:
        out["grads_detached"] = _grads(trainer, x, y)
    finally:
        mesh_mod.all_reduce_sum_grad = differentiable

    # one BatchNorm on its own
    bn = BatchNorm2d(4).train()
    bn.sync_group = mesh
    bx = torch.from_numpy(payload["bn_x"][4 * r : 4 * (r + 1)])
    out["bn"] = (bn(bx).detach().numpy(), bn.running_mean.numpy().copy(),
                 bn.running_var.numpy().copy())

    # a data-parallel trainer for 3 epochs (JAX: tests/test_parallel.py)
    cfg = _v2_cfg(batch=64)
    ts, vs = loop.make_samplers(cfg, _fold(2, 3000), torch.device("cpu"))
    model = get_model(cfg.model)
    trainer = DataParallelTrainer(model, cfg.train, ts, vs, mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    rngs = trainer.replica_rngs(torch.device("cpu"), 1)
    losses = []
    for _ in range(3):
        state, scores = trainer.train_epoch(state, rngs, 6)
        losses.append(float(scores["loss"]))
    val = trainer.eval_epoch(state, rngs.val, 3)
    out["dp"] = {"losses": losses, "local_batch": trainer.local_batch,
                 "val": {k: float(v) for k, v in val.items()},
                 "params": _numpy(model.state_dict())}

    # the sweep against one device's, on the same parameters
    seq = _seq_cfg()
    seq_fold = train_app.synthetic_folds(1, frames=1700, seed=4, n_classes=6)[1]
    ts, vs = loop.make_samplers(seq, seq_fold, torch.device("cpu"))
    model = get_model(seq.model).init_parameters(torch.Generator().manual_seed(5))
    dp = DataParallelTrainer(model, seq.train, ts, vs, mesh)
    one = loop.Trainer(model, seq.train, ts, vs)
    out["sweep"] = ({k: float(v) for k, v in dp.eval_sweep(None).items()},
                    {k: float(v) for k, v in one.eval_sweep(None).items()})

    # a data-parallel run_fold: rank 0 writes, every rank returns the same
    res = loop.run_fold(seq, seq_fold, 1, payload["dirs"]["fold"], verbose=False, device="cpu",
                        trainer_factory=loop.data_parallel_factory(mesh))
    out["run_fold"] = res

    # per-process shards and their starved-shard errors
    out["shard"] = shard_fold_data(payload["fold"], mesh, seq_len_in=64)["train_x"]
    errors = []
    for fold in (_adversarial(),):
        try:
            shard_fold_data(fold, mesh, seq_len_in=64)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["shard_errors"] = errors

    # fit_norm_stats over the ranks' shards of one corpus
    stats = fit_norm_stats(torch.from_numpy(payload["norm_x"][50 * r : 50 * (r + 1)]), mesh)
    out["norm"] = (stats.mean.numpy(), stats.scale.numpy())

    # the sharded feed
    out["prefetch"] = [b["x"].numpy() for b in pipeline.sharded_prefetch(
        iter(payload["batches"]), mesh, depth=2)]

    # sharded evaluation: one model and a 2-member ensemble
    members = [get_model(seq.model).init_parameters(torch.Generator().manual_seed(s))
               for s in (6, 7)]
    ex, ey = seq_fold["val_x"], seq_fold["val_y"]
    out["evaluate"] = [
        (evaluate.evaluate_split(m, ex, ey, seq, batch_size=4, mesh=mesh),
         evaluate.evaluate_split(m, ex, ey, seq, batch_size=4, device="cpu"))
        for m in (members[0], members)]

    # the seed mesh, and each rank's share run alone in one process
    seeds = multiseed.run_seeds(3, N_SEEDS)
    folds = train_app.synthetic_folds(1, frames=1700, seed=8, n_classes=6)
    sharded = multiseed.run_fold_multiseed(seq, folds[1], 1, payload["dirs"]["seeds"], seeds,
                                           verbose=False, mesh=mesh)
    mine = seeds[2 * r : 2 * r + 2]
    alone = multiseed.run_fold_multiseed(seq, folds[1], 1,
                                         os.path.join(payload["dirs"]["alone"], str(r)), mine,
                                         verbose=False, device="cpu")
    out["multiseed"] = (sharded, alone, mine)
    out["lanes"] = multiseed.shard_lanes({"w": np.arange(8).reshape(4, 2)}, mesh)["w"]

    out["counts"] = dict(mesh_mod.counts)

    # a collective that rank 1 never joins fails rank 0 within its timeout.
    # The group's own rendezvous is bound by that timeout too, so both ranks
    # first meet on the long-timeout group: the work above ends at different
    # times on each rank, by more than 3 s on a loaded host.
    mesh_mod.barrier(mesh)
    short = dist.new_group([0, 1], timeout=datetime.timedelta(seconds=3), backend="gloo")
    t0 = time.monotonic()
    if r == 0:
        try:
            dist.all_reduce(torch.ones(1), group=short)
            out["missed"] = None
        except RuntimeError as e:
            out["missed"] = (time.monotonic() - t0, str(e))
    else:
        time.sleep(6.0)
    return out


@pytest.fixture(scope="module")
def jax_v2():
    """JAX's timepooled-v2 at float32, its PRNGKey(0) weights, a fixed
    global batch and its single-device global-batch gradient."""
    import jax
    import jax.numpy as jnp

    from sed_crnn_tpu.core.config import get_preset as jax_preset
    from sed_crnn_tpu.models import get_model as jax_get_model
    from sed_crnn_tpu.nn.layers import Ctx
    from sed_crnn_tpu.ops.losses import bce_with_logits

    jcfg = jax_preset("timepooled-v2").model
    jm = jax_get_model(dataclasses.replace(jcfg, dropout=0.0, compute_dtype="float32"))
    params, state = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 64, 40)).astype(np.float32)
    y = (rng.random((32, 8, 1)) < 0.5).astype(np.float32)

    def loss_of(p):
        logits, new_state, _ = jm.apply(p, state, jnp.asarray(x), Ctx(train=True))
        return bce_with_logits(logits, jnp.asarray(y)), new_state

    (_, new_state), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    host = jax.tree_util.tree_map(np.asarray, (params, state, grads, new_state))
    return {"params": host[0], "state": host[1], "grads": host[2], "new_state": host[3],
            "x": x, "y": y}


@pytest.fixture(scope="module")
def two_ranks(jax_v2, tmp_path_factory):
    base = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(3)
    payload = {
        "v2_state": from_jax(jax_v2["params"], jax_v2["state"], _v2_cfg().model),
        "x": jax_v2["x"], "y": jax_v2["y"],
        "bn_x": (1.5 * rng.standard_normal((8, 4, 5, 3)) + 0.3).astype(np.float32),
        "norm_x": (2.0 * rng.standard_normal((100, 40)) + 1.0).astype(np.float32),
        "batches": [{"x": rng.standard_normal((6, 3)).astype(np.float32)} for _ in range(5)],
        "fold": _fold(9, 4000),
        "dirs": {k: str(base / k) for k in ("fold", "seeds", "alone")},
    }
    t0 = time.monotonic()
    results = mesh_mod.spawn_ranks(_ranks, 2, (payload,), device="cpu",
                                   timeout=SPAWN_TIMEOUT_S)
    return payload, results, time.monotonic() - t0


# ---- one process (first: JAX's CPU threads, once started, slow torch's) ----


def test_dp_resume_continues_each_replica(tmp_path):
    """A world-size-1 data-parallel run_fold is run_fold, bitwise (histories
    and checkpoints), and resumes from its own checkpoint like run_fold."""
    seq = _seq_cfg()
    fold = train_app.synthetic_folds(1, frames=1700, seed=4, n_classes=6)[1]
    plain = loop.run_fold(seq, fold, 1, str(tmp_path / "plain"), verbose=False, device="cpu")
    mesh = mesh_mod.make_mesh(1, device="cpu")
    try:
        dp = loop.run_fold(seq, fold, 1, str(tmp_path / "dp"), verbose=False, device="cpu",
                           trainer_factory=loop.data_parallel_factory(mesh))
        assert dp.history == plain.history
        for name in ("best_fold1.npz", "last_fold1.npz"):
            a = port_ckpt._flatten(port_ckpt.load_checkpoint(str(tmp_path / "plain" / name))[0])
            b = port_ckpt._flatten(port_ckpt.load_checkpoint(str(tmp_path / "dp" / name))[0])
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        longer = dataclasses.replace(seq, train=dataclasses.replace(seq.train, max_epochs=3))
        resumed = loop.run_fold(longer, fold, 1, str(tmp_path / "dp"), verbose=False,
                                device="cpu", resume_from=str(tmp_path / "dp/last_fold1.npz"),
                                trainer_factory=loop.data_parallel_factory(mesh))
        alone = loop.run_fold(longer, fold, 1, str(tmp_path / "plain"), verbose=False,
                              device="cpu", resume_from=str(tmp_path / "plain/last_fold1.npz"))
        assert resumed.history == alone.history and resumed.epochs_run == 3
    finally:
        mesh.close()


def test_train_cli_data_parallel_1_is_the_plain_run(tmp_path, monkeypatch):
    seq = _seq_cfg()
    monkeypatch.setattr(train_app, "get_preset", lambda name: seq)
    common = ["--synthetic", "--folds", "1", "--batch-size", "32", "--max-epochs", "1",
              "--device", "cpu"]
    plain = train_app.main(common + ["--art-dir", str(tmp_path / "plain")])
    dp = train_app.main(common + ["--art-dir", str(tmp_path / "dp"), "--data-parallel", "1"])
    assert [r.history for r in dp["folds"]] == [r.history for r in plain["folds"]]
    stacked = train_app.main(common + ["--art-dir", str(tmp_path / "s"), "--runs", "2",
                                       "--seed-parallel", "1"])
    alone = multiseed.run_experiment_multiseed(
        dataclasses.replace(seq, train=dataclasses.replace(seq.train, batch_size=32,
                                                           max_epochs=1)),
        train_app.synthetic_folds(1, frames=max(8000, int(32 * 64 * 1.3)), n_classes=6),
        str(tmp_path / "a"), n_runs=2, mode="stacked", verbose=False, device="cpu")
    assert stacked["er_by_seed"] == alone["er_by_seed"]
    assert not dist.is_initialized()


def test_evaluate_cli_data_parallel_gives_the_same_report(tmp_path, monkeypatch):
    seq = _seq_cfg()
    monkeypatch.setattr(eval_app, "get_preset", lambda name: seq)
    model = get_model(seq.model).init_parameters(torch.Generator().manual_seed(11))
    params, state = to_jax(model.state_dict(), seq.model)
    ckpt = port_ckpt.save_checkpoint(str(tmp_path / "ck.npz"),
                                     {"params": params, "model_state": state}, {"epoch": 1})
    fold = train_app.synthetic_folds(1, frames=1700, seed=4, n_classes=6)[1]
    np.savez(str(tmp_path / "mbe_mon_fold1.npz"), fold["train_x"], fold["train_y"],
             fold["val_x"], fold["val_y"])
    base = ["--checkpoint", ckpt, "--cache-dir", str(tmp_path), "--batch-size", "4",
            "--device", "cpu"]
    assert eval_app.main(base + ["--data-parallel"]) == eval_app.main(base)
    assert not dist.is_initialized()


# ---- mesh ---------------------------------------------------------------------------


def test_make_mesh_and_local_batch_slice_match_jax(monkeypatch):
    from sed_crnn_tpu.parallel import mesh as jax_mesh

    assert mesh_mod.DATA_AXIS == jax_mesh.DATA_AXIS == "data"
    mesh = mesh_mod.make_mesh(1, device="cpu")
    try:
        assert (mesh.size, mesh.rank, mesh.shape, mesh.owned) == (1, 0, {"data": 1}, True)
        assert mesh_mod.local_batch_slice(128, mesh) == 128
        # the first mesh stands: another make_mesh joins it
        assert mesh_mod.make_mesh(device="cpu").size == 1
    finally:
        mesh.close()
    assert not dist.is_initialized()
    fake = mesh_mod.Mesh("data", 8, 3, torch.device("cpu"), None)
    assert mesh_mod.local_batch_slice(128, fake) == 16
    with pytest.raises(ValueError) as got:
        mesh_mod.local_batch_slice(100, fake)
    with pytest.raises(ValueError) as want:
        jax_mesh.local_batch_slice(100, jax_mesh.make_mesh(8))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs 2 processes"):
        mesh_mod.make_mesh(2, device="cpu")
    # N above the visible cards: the JAX message
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError) as got:
        mesh_mod.make_mesh(2, device="cuda")
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(len(jax_mesh.jax.devices()) + 1)
    n_jax = len(jax_mesh.jax.devices())
    assert str(got.value) == "requested 2 devices, have 1"
    assert str(want.value) == f"requested {n_jax + 1} devices, have {n_jax}"
    with pytest.raises(ValueError, match="requested 3 devices, have 1"):
        mesh_mod.spawn_ranks(print, 3, device="cuda")


def test_initialize_multihost_is_a_no_op_without_a_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    mesh_mod.initialize_multihost()
    assert not dist.is_initialized() and not mesh_mod.launched()


def test_spawned_ranks_report_and_stay_bounded(two_ranks):
    _, results, seconds = two_ranks
    assert len(results) == 2 and seconds < SPAWN_TIMEOUT_S
    # both ranks ran the same collectives
    assert results[0]["counts"] == results[1]["counts"]
    assert results[0]["counts"]["collectives"] > 0


def test_a_missed_collective_fails_within_the_group_timeout(two_ranks):
    _, results, _ = two_ranks
    waited, message = results[0]["missed"]
    assert 2.5 < waited < 6.0, waited
    assert message


# ---- cross-replica BatchNorm and the gradient --------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _grad_gaps(grads, reference):
    """Per JAX leaf, max |grads - reference| (both port-layout dicts, or
    ``reference`` a JAX tree)."""
    got, _ = to_jax(grads, _v2_cfg().model)
    if not isinstance(reference, dict) or "bn" not in reference:
        reference, _ = to_jax(reference, _v2_cfg().model)
    want, have = dict(_leaves(reference)), dict(_leaves(got))
    assert set(have) == set(want)
    return {k: float(np.abs(have[k] - want[k]).max()) for k in want}


@pytest.fixture(scope="module")
def single_device_grads(jax_v2):
    """The port's gradient of the whole global batch on one device."""
    cfg = _v2_cfg()
    model = get_model(cfg.model)
    model.load_state_dict(from_jax(jax_v2["params"], jax_v2["state"], cfg.model))
    trainer = loop.Trainer(model, cfg.train, None, None)
    return _grads(trainer, torch.from_numpy(jax_v2["x"]), torch.from_numpy(jax_v2["y"]))


def test_dp_gradient_equals_jax_global_batch_gradient(two_ranks, jax_v2, single_device_grads):
    _, results, _ = two_ranks
    single_gap = _grad_gaps(single_device_grads, jax_v2["grads"])
    assert max(single_gap.values()) <= SINGLE_DEVICE_JAX_GAP, single_gap
    for r in results:
        gaps = _grad_gaps(r["grads"], jax_v2["grads"])
        over = {k: (gaps[k], single_gap[k]) for k in gaps if gaps[k] > single_gap[k] + GRAD_ATOL}
        assert not over, over
        to_single = _grad_gaps(r["grads"], single_device_grads)
        assert max(to_single.values()) < GRAD_ATOL, to_single
    for k in results[0]["grads"]:
        assert torch.equal(results[0]["grads"][k], results[1]["grads"][k]), k


def test_a_batchnorm_reduction_autograd_misses_fails_the_gradient(two_ranks, jax_v2,
                                                                  single_device_grads):
    _, results, _ = two_ranks
    single_gap = _grad_gaps(single_device_grads, jax_v2["grads"])
    gaps = _grad_gaps(results[0]["grads_detached"], jax_v2["grads"])
    assert max(gaps[k] - single_gap[k] for k in gaps) > 50 * GRAD_ATOL, gaps
    to_single = _grad_gaps(results[0]["grads_detached"], single_device_grads)
    assert max(to_single.values()) > 50 * GRAD_ATOL, to_single


def test_dp_running_statistics_match_jax(two_ranks, jax_v2):
    _, results, _ = two_ranks
    want = jax_v2["new_state"]["bn"]
    for r in results:
        running = r["running"]
        for i, w in enumerate(want):
            pre = [k for k in running if k.endswith("running_mean")][i].rsplit(".", 1)[0]
            np.testing.assert_allclose(running[f"{pre}.running_mean"], w["mean"], atol=1e-6)
            np.testing.assert_allclose(running[f"{pre}.running_var"], w["var"], rtol=1e-5)


def test_cross_replica_batchnorm_matches_jax_axis_name(two_ranks):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from sed_crnn_tpu.nn.layers import BatchNorm2d as JaxBatchNorm2d, Ctx

    payload, results, _ = two_ranks
    x = np.transpose(payload["bn_x"], (0, 2, 3, 1))   # NCHW -> NHWC
    bn = JaxBatchNorm2d(4)
    params, state = bn.init(None)

    def body(xs):
        y, new_state = bn.apply(params, state, xs, Ctx(train=True, axis_name="data"))
        return y, new_state

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    y, new_state = shard_map(body, mesh=mesh, in_specs=P("data"),
                             out_specs=(P("data"), P()))(jnp.asarray(x))
    y = np.transpose(np.asarray(y), (0, 3, 1, 2))
    for r, res in enumerate(results):
        out, mean, var = res["bn"]
        np.testing.assert_allclose(out, y[4 * r : 4 * (r + 1)], atol=1e-5)
        np.testing.assert_allclose(mean, np.asarray(new_state["mean"]), atol=1e-6)
        np.testing.assert_allclose(var, np.asarray(new_state["var"]), rtol=1e-5)


# ---- the data-parallel trainer --------------------------------------------------


def test_dp_trainer_learns_and_keeps_ranks_bitwise_equal(two_ranks):
    _, results, _ = two_ranks
    a, b = results[0]["dp"], results[1]["dp"]
    assert a["local_batch"] == 32
    assert a["losses"][-1] < a["losses"][0], a["losses"]
    assert a["losses"] == b["losses"] and a["val"] == b["val"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)
    # the predictions gathered cover the global batch (3 steps x 64 x T_out x 1)
    v = a["val"]
    assert int(v["tn"] + v["fp"] + v["fn"] + v["tp"]) == 3 * 64 * 8 * 1


def test_dp_sweep_equals_the_single_device_sweep(two_ranks):
    _, results, _ = two_ranks
    for r in results:
        dp, one = r["sweep"]
        assert set(dp) == set(one)
        for k in one:
            if k == "loss":
                assert dp[k] == pytest.approx(one[k], rel=1e-6)
            else:
                assert dp[k] == one[k], k
    assert results[0]["sweep"][0] == results[1]["sweep"][0]


def test_dp_run_fold_writes_once_and_returns_the_same_result(two_ranks):
    payload, results, _ = two_ranks
    a, b = results[0]["run_fold"], results[1]["run_fold"]
    assert a == b and a.epochs_run == 2
    d = payload["dirs"]["fold"]
    assert sorted(os.listdir(d)) == ["best_fold1.npz", "last_fold1.npz", "train_fold1.jsonl"]
    assert len(open(os.path.join(d, "train_fold1.jsonl")).read().splitlines()) == 2
    tree, meta = port_ckpt.load_checkpoint(os.path.join(d, "last_fold1.npz"))
    assert meta["epoch"] == 2 and len(tree["torch_rng_replicas"]) == 1


def test_shard_fold_data_matches_jax_word_for_word(two_ranks, monkeypatch):
    import jax

    from sed_crnn_tpu.parallel import data_parallel as jax_dp

    payload, results, _ = two_ranks
    x = payload["fold"]["train_x"]
    np.testing.assert_array_equal(results[0]["shard"], x[:2000])
    np.testing.assert_array_equal(results[1]["shard"], x[2000:])
    one = mesh_mod.Mesh("data", 1, 0, torch.device("cpu"), None)
    assert shard_fold_data(payload["fold"], one) is payload["fold"]
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for pid, res in enumerate(results):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        for fold, got in zip((_adversarial(),), res["shard_errors"]):
            try:
                jax_dp.shard_fold_data(fold, None, seq_len_in=64)
                want = None
            except ValueError as e:
                want = str(e)
            assert got == want
    assert results[0]["shard_errors"] == [None]
    assert "NO positive" in results[1]["shard_errors"][0]


def test_shard_fold_data_no_negative_error_matches_jax(monkeypatch):
    import jax

    from sed_crnn_tpu.parallel import data_parallel as jax_dp

    fold = _adversarial()
    fold["train_y"] = fold["val_y"]      # host 1's train half: positive throughout
    fold["train_x"] = fold["val_x"]
    mesh = mesh_mod.Mesh("data", 2, 1, torch.device("cpu"), None)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    with pytest.raises(ValueError) as got:
        shard_fold_data(fold, mesh, seq_len_in=64)
    with pytest.raises(ValueError) as want:
        jax_dp.shard_fold_data(fold, None, seq_len_in=64)
    assert str(got.value) == str(want.value) and "no clean 64-frame negative" in str(got.value)


# ---- feeds and statistics -------------------------------------------------------


def test_device_prefetch_order_and_content():
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(7)]
    out = list(pipeline.device_prefetch(iter(batches), depth=3, device="cpu"))
    assert len(out) == 7
    for got, ref in zip(out, batches):
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), ref)
    trees = [{"x": b, "y": (b[:1], b[1:])} for b in batches[:2]]
    got = list(pipeline.device_prefetch(trees, device="cpu"))
    np.testing.assert_array_equal(got[1]["y"][1].numpy(), batches[1][1:])
    with pytest.raises(ValueError, match="prefetch depth must be >= 1"):
        pipeline.device_prefetch(iter(batches), depth=0, device="cpu")


def test_sharded_prefetch_gives_each_rank_its_slice(two_ranks):
    payload, results, _ = two_ranks
    for r, res in enumerate(results):
        assert len(res["prefetch"]) == len(payload["batches"])
        for got, b in zip(res["prefetch"], payload["batches"]):
            np.testing.assert_array_equal(got, b["x"][3 * r : 3 * (r + 1)])


def test_fit_norm_stats_over_a_group_matches_jax_axis_name(two_ranks):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from sed_crnn_tpu.ops import frontend as jax_frontend

    payload, results, _ = two_ranks
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    want = shard_map(lambda xs: tuple(jax_frontend.fit_norm_stats(xs, "data")), mesh=mesh,
                     in_specs=P("data"), out_specs=(P(), P()))(jnp.asarray(payload["norm_x"]))
    whole = fit_norm_stats(torch.from_numpy(payload["norm_x"]))
    for res in results:
        mean, scale = res["norm"]
        np.testing.assert_allclose(mean, np.asarray(want[0]), atol=1e-6)
        np.testing.assert_allclose(scale, np.asarray(want[1]), atol=1e-6)
        np.testing.assert_allclose(mean, whole.mean.numpy(), atol=1e-6)


# ---- sharded evaluation ------------------------------------------------------------


def test_sharded_evaluate_split_equals_the_single_device_report(two_ranks):
    _, results, _ = two_ranks
    for res in results:
        for sharded, single in res["evaluate"]:
            assert sharded == single
    assert results[0]["evaluate"] == results[1]["evaluate"]


# ---- the seed mesh -------------------------------------------------------------------


def _same_runs(a, b):
    assert [r.history for r in a] == [r.history for r in b]
    assert [(r.best_er, r.best_f1, r.best_epoch, r.epochs_run) for r in a] == [
        (r.best_er, r.best_f1, r.best_epoch, r.epochs_run) for r in b]
    for x, y in zip(a, b):
        fa = port_ckpt._flatten(port_ckpt.load_checkpoint(x.best_checkpoint)[0])
        fb = port_ckpt._flatten(port_ckpt.load_checkpoint(y.best_checkpoint)[0])
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_seed_mesh_ranks_train_their_share_as_one_process_would(two_ranks):
    payload, results, _ = two_ranks
    everything = results[0]["multiseed"][0]
    assert len(everything) == N_SEEDS
    assert [r.history for r in results[1]["multiseed"][0]] == [r.history for r in everything]
    for r, res in enumerate(results):
        sharded, alone, mine = res["multiseed"]
        assert mine == multiseed.run_seeds(3, N_SEEDS)[2 * r : 2 * r + 2]
        _same_runs(sharded[2 * r : 2 * r + 2], alone)
        for s in mine:
            assert os.path.exists(os.path.join(payload["dirs"]["seeds"], f"seed{s}",
                                               "best_fold1.npz"))
    np.testing.assert_array_equal(results[1]["lanes"], [[4, 5], [6, 7]])


def test_seed_mesh_refusals_match_jax(tmp_path):
    import jax

    from sed_crnn_tpu.core.config import TrainConfig as JaxTrainConfig
    from sed_crnn_tpu.core.config import get_preset as jax_preset
    from sed_crnn_tpu.models import get_model as jax_get_model
    from sed_crnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from sed_crnn_tpu.train import multiseed as jax_multiseed

    seq = _seq_cfg()
    folds = train_app.synthetic_folds(1, frames=1700, seed=8, n_classes=6)
    fake = mesh_mod.Mesh("seed", 2, 0, torch.device("cpu"), None)
    with pytest.raises(ValueError) as got:
        multiseed.run_fold_multiseed(seq, folds[1], 1, str(tmp_path), [1, 2, 3], mesh=fake)
    jm = jax_get_model(jax_preset("timepooled-v2").model)
    with pytest.raises(ValueError) as want:
        jax_multiseed.MultiSeedTrainer(jm, JaxTrainConfig(), None, None, 3,
                                       jax_make_mesh(2, axis_name="seed"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        multiseed.shard_lanes({"w": np.zeros((3, 1))}, fake)
    assert str(got.value) == str(want.value)
    assert multiseed.choose_runs_mode(seq, 8, fake) == "stacked"
    assert multiseed.choose_runs_mode(get_preset("sednet-dcase"), 8) == "sequential"
    assert jax_multiseed.choose_runs_mode(seq, 8, jax.devices()) == "stacked"
    with pytest.raises(ValueError) as got:
        multiseed.run_experiment_multiseed(seq, folds, str(tmp_path / "x"), n_runs=2,
                                           mode="sequential", mesh=fake, verbose=False)
    assert str(got.value) == "mode='sequential' does not shard seeds; drop mesh"
    assert not os.path.exists(tmp_path / "x")


# ---- the CLIs ------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--runs", "2", "--data-parallel", "2"],
    ["--runs", "2", "--seed-parallel", "2", "--runs-mode", "sequential"],
    ["--runs", "2", "--resume"],
])
def test_train_cli_refusals_match_jax(tmp_path, capsys, monkeypatch, flags):
    from sed_crnn_tpu.apps import train as jax_train_app
    from sed_crnn_tpu.core import runtime

    # the JAX CLI's PRNG and compilation-cache settings are process-wide
    monkeypatch.setattr(runtime, "configure", lambda **kw: None)

    texts = []
    for main, extra in ((train_app.main, ["--device", "cpu"]), (jax_train_app.main, [])):
        with pytest.raises(SystemExit):
            main(["--synthetic", "--folds", "1", "--art-dir", str(tmp_path), *flags, *extra])
        err = capsys.readouterr().err.strip().splitlines()[-1]
        texts.append(err.split("error: ", 1)[1])
    assert texts[0] == texts[1]
