"""The port's one-command DCASE reproduction script
(`sed_crnn_torch/apps/reproduce_dcase.py`) on the CPU, on the JAX tests'
synthetic miniature corpus (`tests/test_pipeline_dcase.py::_fake_dcase_root`;
the real corpus is not in the repository): the report has the JAX script's
keys, protocol string, baselines and rounding; its numbers are
`run_experiment_multiseed` on the cache it wrote; the cache's file names are
the JAX script's, and its arrays are the JAX script's within the feature
CLIs' band (`tests/test_torch_feature.py`: 2e-4 in the log domain, the
packs' normalized features within twice that over the scale); without
matplotlib it trains without plots; and ``--seed-parallel 2`` (two spawned
gloo ranks) gives the same report. The JAX script's own test
(`tests/test_reproduce_dcase.py`) stays in the slow tier; here JAX runs only
its feature extraction, for the cache.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from sed_crnn_torch.apps import reproduce_dcase
from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.data import store
from sed_crnn_torch.train import multiseed
from tests.test_pipeline_dcase import _fake_dcase_root
from tests.test_torch_feature import _assert_log_close, _assert_packs_close, _per_file

FEATURE_ATOL = 2e-4  # tests/test_torch_feature.py's band for the default frontend

ARGS = ["--folds", "1", "2", "--runs", "2", "--max-epochs", "2", "--batch-size", "4",
        "--smoke", "--device", "cpu"]
REPORT_KEYS = {"protocol", "channel", "er_1s", "f1_1s", "std_er", "std_f1", "baseline_er",
               "baseline_f1", "delta_er", "delta_f1", "smoke"}


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    base = tmp_path_factory.mktemp("reproduce")
    root = _fake_dcase_root(base, np.random.default_rng(0))
    out = str(base / "report.json")
    report = reproduce_dcase.main(["--dcase-root", root, "--art-dir", str(base / "art"),
                                   "--out", out, *ARGS])
    return base, root, out, report


def test_report_has_the_jax_scripts_keys_and_baselines(driven, capsys):
    _, _, out, report = driven
    assert set(report) == REPORT_KEYS
    assert report["protocol"] == "2-fold x 2-seed, sednet-dcase"
    assert report["channel"] == "single" and report["smoke"] is True
    assert (report["baseline_er"], report["baseline_f1"]) == (0.60, 0.57)
    assert reproduce_dcase.BASELINES == {"mon": {"er": 0.60, "f1": 0.57},
                                         "bin": {"er": 0.60, "f1": 0.59}}
    assert json.loads(open(out).read()) == report
    assert report["delta_er"] == round(report["er_1s"] - 0.60, 4)


def test_report_numbers_are_run_experiment_multiseed_on_its_cache(driven, tmp_path):
    _, root, _, report = driven
    cfg = get_preset("sednet-dcase")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, conv_channels=(8, 8, 8), gru_hidden=(4, 4),
                                  seq_len_in=64),
        train=dataclasses.replace(cfg.train, max_epochs=2, batch_size=4))
    folds = store.load_all_folds(os.path.join(root, "sedtpu_cache"), [1, 2], "mon")
    out = multiseed.run_experiment_multiseed(cfg, folds, str(tmp_path), n_runs=2,
                                             verbose=False, device="cpu")
    for key, src in (("er_1s", "mean_er"), ("f1_1s", "mean_f1"), ("std_er", "std_er"),
                     ("std_f1", "std_f1")):
        assert report[key] == round(out[src], 4), key


@pytest.fixture(scope="module")
def jax_cache(driven, tmp_path_factory):
    """The JAX feature CLI's cache of the same layout."""
    from sed_crnn_tpu.apps import feature as jax_feature
    from sed_crnn_tpu.core import runtime

    _, root, _, _ = driven
    jcache = str(tmp_path_factory.mktemp("jax_cache"))
    # the JAX CLI's compilation cache is process-wide
    enable = runtime.enable_compilation_cache
    runtime.enable_compilation_cache = lambda *a, **k: None
    try:
        jax_feature.main(["--dcase-root", root, "--cache-dir", jcache, "--scene", "street",
                          "--folds", "1", "2"])
    finally:
        runtime.enable_compilation_cache = enable
    return jcache


def test_cache_file_names_are_the_jax_scripts(driven, jax_cache):
    _, root, _, _ = driven
    assert sorted(os.listdir(os.path.join(root, "sedtpu_cache"))) == sorted(
        os.listdir(jax_cache))


def test_cache_arrays_match_the_jax_scripts(driven, jax_cache):
    _, root, _, _ = driven
    cache = os.path.join(root, "sedtpu_cache")
    files = _per_file(cache, "mon")
    assert files == _per_file(jax_cache, "mon") and files
    for f in files:
        x, y = store.load_video_features(os.path.join(cache, f))
        jx, jy = store.load_video_features(os.path.join(jax_cache, f))
        _assert_log_close(x, jx, FEATURE_ATOL)
        np.testing.assert_array_equal(y, jy)
    _assert_packs_close(cache, jax_cache, (1, 2), "mon", FEATURE_ATOL)


def test_protocol_artifacts_land_in_the_art_dir(driven):
    base, _, _, _ = driven
    art = base / "art"
    assert os.path.exists(art / "experiment_multiseed.jsonl")
    seeds = multiseed.run_seeds(get_preset("sednet-dcase").train.seed, 2)
    for k in (1, 2):
        for s in seeds:
            assert os.path.exists(art / f"fold{k}" / f"seed{s}" / f"best_fold{k}.npz")


def test_seed_parallel_2_gives_the_same_report(driven, capsys):
    base, root, _, report = driven
    capsys.readouterr()
    sharded = reproduce_dcase.main(["--dcase-root", root, "--art-dir", str(base / "art2"),
                                    *ARGS, "--seed-parallel", "2"])
    assert sharded == report
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report


def test_without_matplotlib_it_trains_without_plots(driven, tmp_path, monkeypatch, capsys):
    _, root, _, _ = driven
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # any import of it fails
    art = tmp_path / "art"
    report = reproduce_dcase.main(["--dcase-root", root, "--art-dir", str(art), "--folds", "1",
                                   "--runs", "1", "--max-epochs", "1", "--batch-size", "4",
                                   "--smoke", "--device", "cpu"])
    assert "matplotlib is not installed" in capsys.readouterr().err
    assert report["protocol"] == "1-fold x 1-seed, sednet-dcase"
    assert os.path.exists(art / "fold1" / "best_fold1.npz")
    assert not [f for _, _, fs in os.walk(art) for f in fs if f.endswith(".png")]
