"""Multi-seed training on the CPU: the port's `train/multiseed.py` and
`apps/train.py --runs` against `run_fold` and the JAX package's protocol
arithmetic, on narrowed `sednet-dcase` and tiny synthetic folds, in both
modes (`tests/test_torch_multiseed_stacked.py` holds stacked mode's seeds
against `run_fold`).

Each seed of the experiment must be exactly `run_fold(seed=s)` (equal
histories, bitwise-equal checkpoints), and the seed-major mean and std, the
per-seed lists and the `experiment_multiseed.jsonl` record must equal what
the JAX package's `run_experiment_multiseed` computes from the same
per-fold results.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from sed_crnn_tpu.train import loop as jax_loop
from sed_crnn_tpu.train import multiseed as jax_multiseed

from sed_crnn_torch.apps import train as train_app
from sed_crnn_torch.core import checkpoint as port_ckpt
from sed_crnn_torch.train import loop, multiseed
from tests.test_torch_model import narrowed


def _cfgs():
    jc, tc = narrowed("sednet-dcase", dropout=0.0)
    train = dict(batch_size=4, max_epochs=1, plot_every=0)
    return (jc.replace(train=dataclasses.replace(jc.train, **train)),
            tc.replace(train=dataclasses.replace(tc.train, **train)))


def test_run_seeds_match_jax():
    assert multiseed.SEED_STRIDE == jax_multiseed.SEED_STRIDE == 7919
    for base, n in ((0, 5), (3, 2), (42, 1)):
        assert multiseed.run_seeds(base, n) == jax_multiseed.run_seeds(base, n)


def test_sequential_experiment_is_run_fold_per_seed(tmp_path, monkeypatch):
    jc, tc = _cfgs()
    folds = train_app.synthetic_folds(2, frames=1600, seed=5, n_classes=6)
    seeds = multiseed.run_seeds(3, 2)
    out = multiseed.run_experiment_multiseed(tc, folds, str(tmp_path / "m"), seeds=seeds,
                                             mode="sequential", verbose=False, device="cpu")
    assert out["seeds"] == seeds and sorted(out["folds"]) == [1, 2]
    for k in (1, 2):
        for s in seeds:
            d = tmp_path / "m" / f"fold{k}" / f"seed{s}"
            assert {f"best_fold{k}.npz", f"last_fold{k}.npz", f"train_fold{k}.jsonl"} <= set(
                os.listdir(d))
    for j, s in enumerate(seeds):
        alone = loop.run_fold(tc, folds[1], 1, str(tmp_path / f"alone{s}"), seed=s,
                              verbose=False, device="cpu")
        got = out["folds"][1][j]
        assert got.history == alone.history and got.epochs_run == alone.epochs_run == 1
        assert (got.best_er, got.best_f1, got.best_epoch) == (alone.best_er, alone.best_f1,
                                                             alone.best_epoch)
        a, _ = port_ckpt.load_checkpoint(got.best_checkpoint)
        b, _ = port_ckpt.load_checkpoint(alone.best_checkpoint)
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x, y)

    # The JAX package's protocol on the same per-fold results.
    results = {(r.fold_id, s): r for rs in out["folds"].values() for r, s in zip(rs, seeds)}
    monkeypatch.setattr(jax_loop, "run_fold",
                        lambda cfg, fold_data, fold_id, art_dir, seed, **kw: results[(fold_id,
                                                                                      seed)])
    want = jax_multiseed.run_experiment_multiseed(jc, folds, str(tmp_path / "j"), seeds=seeds,
                                                  verbose=False, share_compile=False,
                                                  mode="sequential")
    assert {k: v for k, v in out.items() if k != "folds"} == {
        k: v for k, v in want.items() if k != "folds"}
    assert len(set(out["er_by_seed"])) == 2   # the two seeds trained apart

    assert _record(tmp_path / "m" / "experiment_multiseed.jsonl") == _record(
        tmp_path / "j" / "experiment_multiseed.jsonl")


def _record(path):
    """The one record of an experiment_multiseed.jsonl, less its time."""
    (line,) = open(path).read().splitlines()
    rec = json.loads(line)
    rec.pop("time")
    return rec


def test_modes_that_are_not_ported_raise(tmp_path, monkeypatch):
    """Stacked mode runs (it raised until it was ported) and writes the JAX
    protocol's record from its per-fold results; unknown modes and duplicate
    seeds raise before anything is written."""
    jc, tc = _cfgs()
    folds = train_app.synthetic_folds(1, frames=1600, seed=5, n_classes=6)
    out = multiseed.run_experiment_multiseed(tc, folds, str(tmp_path / "m"), n_runs=2,
                                             mode="stacked", verbose=False, device="cpu")
    seeds = multiseed.run_seeds(tc.train.seed, 2)
    assert out["seeds"] == seeds and len(out["folds"][1]) == 2
    for s in seeds:
        assert os.path.exists(tmp_path / "m" / "fold1" / f"seed{s}" / "best_fold1.npz")
    by_fold = out["folds"]
    monkeypatch.setattr(jax_multiseed, "run_fold_multiseed",
                        lambda cfg, fold_data, fold_id, *a, **kw: by_fold[fold_id])
    jax_multiseed.run_experiment_multiseed(jc, folds, str(tmp_path / "j"), seeds=seeds,
                                           verbose=False, share_compile=False, mode="stacked")
    assert _record(tmp_path / "m" / "experiment_multiseed.jsonl") == _record(
        tmp_path / "j" / "experiment_multiseed.jsonl")
    with pytest.raises(ValueError, match="mode"):
        multiseed.run_experiment_multiseed(tc, folds, str(tmp_path / "x"), mode="fast",
                                           device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        multiseed.run_experiment_multiseed(tc, folds, str(tmp_path / "x"), seeds=[1, 1],
                                           device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["j", "m"]


def test_train_cli_runs(tmp_path, monkeypatch):
    _, tc = _cfgs()
    monkeypatch.setattr(train_app, "get_preset", lambda name: tc)
    out = train_app.main(["--preset", "sednet-dcase", "--synthetic", "--folds", "1",
                          "--runs", "2", "--runs-mode", "sequential", "--batch-size", "16",
                          "--art-dir", str(tmp_path), "--device", "cpu"])
    assert out["seeds"] == multiseed.run_seeds(tc.train.seed, 2) and len(out["folds"][1]) == 2
    (run,) = os.listdir(tmp_path)
    for s in out["seeds"]:
        assert os.path.exists(tmp_path / run / "fold1" / f"seed{s}" / "best_fold1.npz")
    assert os.path.exists(tmp_path / run / "experiment_multiseed.jsonl")
    with pytest.raises(SystemExit):
        train_app.main(["--synthetic", "--runs", "2", "--resume", "--art-dir", str(tmp_path),
                        "--device", "cpu"])
    out = train_app.main(["--preset", "sednet-dcase", "--synthetic", "--folds", "1",
                          "--runs", "2", "--runs-mode", "stacked", "--batch-size", "16",
                          "--art-dir", str(tmp_path / "s"), "--device", "cpu"])
    (run,) = os.listdir(tmp_path / "s")
    rec = _record(tmp_path / "s" / run / "experiment_multiseed.jsonl")
    assert set(rec) == {"mean_er", "std_er", "mean_f1", "std_f1", "er_by_seed", "f1_by_seed",
                        "seeds", "experiment"}
    assert rec["seeds"] == out["seeds"] and rec["mean_er"] == out["mean_er"]
    for s in out["seeds"]:
        assert os.path.exists(tmp_path / "s" / run / "fold1" / f"seed{s}" / "last_fold1.npz")
    # --seed-parallel shards stacked mode only (the JAX CLI's refusal)
    with pytest.raises(SystemExit):
        train_app.main(["--synthetic", "--runs", "2", "--seed-parallel", "2",
                        "--runs-mode", "sequential", "--art-dir", str(tmp_path / "p"),
                        "--device", "cpu"])
    assert not os.path.exists(tmp_path / "p")


def test_train_cli_accepts_slow_prng(tmp_path, monkeypatch):
    """The JAX CLI's ``--slow-prng`` is accepted and selects nothing: the
    run writes the same files, and the same checkpoints, as without it."""
    _, tc = _cfgs()
    monkeypatch.setattr(train_app, "get_preset", lambda name: tc)
    roots = {}
    for tag, extra in (("plain", []), ("slow", ["--slow-prng"])):
        train_app.main(["--preset", "sednet-dcase", "--synthetic", "--folds", "1",
                        "--batch-size", "16", "--art-dir", str(tmp_path / tag),
                        "--device", "cpu", *extra])
        (run,) = os.listdir(tmp_path / tag)
        roots[tag] = tmp_path / tag / run
    files = {tag: sorted(str(p.relative_to(r)) for p in r.rglob("*"))
             for tag, r in roots.items()}
    assert files["plain"] == files["slow"]
    ckpts = [f for f in files["plain"] if f.endswith(".npz")]
    assert ckpts
    for name in ckpts:
        with np.load(roots["plain"] / name) as a, np.load(roots["slow"] / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_multiseed_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multiseed.run_experiment_multiseed(tc, train_app.synthetic_folds(1, frames=1600),
                                           str(tmp_path), n_runs=2)
