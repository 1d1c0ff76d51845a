"""The feature-extraction slice on the CPU: the port's `apps/feature.py`
(with `data/{catalog,xlsx,resample,wavio,store}.py`) against the JAX
package's on the same fake DCASE 2017 and Decorte layouts, the port's own
packs training `sednet-dcase-binmul`, and the legacy statistics refit of
`apps/infer.py::stats_from_fold`.

Tolerances: per-file log-mel caches within 5e-4 (the port's float32 DIF
kernel path against the JAX bf16x3 Pallas kernels, run interpreted) or 2e-4
(the fft backends of the two frameworks); labels equal. A pack's X is
``(x - mean) / scale`` with mean and scale fit on the train split: an error
e in the features moves the mean by at most e, so each packed column is held
within ``2 e / scale`` (the JAX scale), and the recorded mean within e and
the scale within e of each other. Resampled audio within 1e-6 (one numpy
algorithm in both packages, float64 inside).
"""

import dataclasses
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from sed_crnn_tpu.apps import feature as jax_feature
from sed_crnn_tpu.apps import infer as jax_infer
from sed_crnn_tpu.data import catalog as jax_catalog
from sed_crnn_tpu.data import resample as jax_resample
from sed_crnn_tpu.data import store as jax_store
from sed_crnn_tpu.data import wavio as jax_wavio
from sed_crnn_tpu.data import xlsx as jax_xlsx
from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.nn.layers import Ctx

from sed_crnn_torch.apps import feature
from sed_crnn_torch.apps import infer
from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.data import catalog, resample, store, wavio, xlsx
from sed_crnn_torch.models.convert import from_jax, to_jax
from sed_crnn_torch.train import loop
from tests.test_torch_model import narrowed, port_model, seeded_tree

SR = 44100
CLASSES = jax_catalog.DCASE_CLASSES


def _noise_tones(rng, seconds, sr=SR, channels=2):
    t = np.arange(int(seconds * sr)) / sr
    x = 0.05 * rng.standard_normal((t.size, channels))
    for c in range(channels):
        x[:, c] += 0.3 * np.sin(2 * np.pi * (440.0 * (c + 1)) * t) * (np.floor(t) % 2)
    return x.astype(np.float32)


def _fake_dcase_root(root, seed, binaural=True):
    """4 wavs of 3 s at 44.1 kHz and one of 1 s at 48 kHz (fold 1's evaluate
    list, resampled on the host), folds 1 and 2 of the street scene."""
    rng = np.random.default_rng(seed)
    audio = root / "audio" / "street"
    setup = root / "evaluation_setup"
    audio.mkdir(parents=True)
    setup.mkdir()
    names = [f"a{i:03d}.wav" for i in range(4)]
    for name in names:
        x = _noise_tones(rng, 3.0)
        wavio.write_wav(str(audio / name), x if binaural else x[:, 0], SR)
    x48 = _noise_tones(rng, 1.0, sr=48000)
    wavio.write_wav(str(audio / "b48k.wav"), x48 if binaural else x48[:, 0], 48000)

    def ann(fname, events):
        if not events:
            return [f"audio/street/{fname}\tstreet"]
        return [f"audio/street/{fname}\tstreet\t{s}\t{e}\t{lab}" for s, e, lab in events]

    for fold in (1, 2):
        train = [n for i, n in enumerate(names) if i % 2 != fold % 2]
        test = [n for i, n in enumerate(names) if i % 2 == fold % 2]
        if fold == 1:
            test.append("b48k.wav")
        train_lines = sum((ann(n, [(0.5, 1.0, "car"), (1.5, 2.0, "children")])
                           for n in train), [])
        test_lines = sum((ann(n, [(0.2, 0.8, "people walking")]) for n in test), [])
        (setup / f"street_fold{fold}_train.txt").write_text("\n".join(train_lines) + "\n")
        (setup / f"street_fold{fold}_evaluate.txt").write_text("\n".join(test_lines) + "\n")
    return str(root)


def _per_file(cache, tag):
    return sorted(f for f in os.listdir(cache) if f.endswith(f"_{tag}.npz")
                  and not f.startswith("mbe_"))


def _assert_log_close(got, want, atol):
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol)


def _assert_packs_close(cache, jcache, folds, tag, err):
    for k in folds:
        got, want = store.load_fold(cache, k, tag), jax_store.load_fold(jcache, k, tag)
        scale = want["norm_scale"]
        for key in ("train_y", "val_y"):
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_allclose(got["norm_mean"], want["norm_mean"], atol=err)
        np.testing.assert_allclose(got["norm_scale"], scale, atol=err)
        for key in ("train_x", "val_x"):
            assert got[key].shape == want[key].shape
            assert (np.abs(got[key] - want[key]) <= 2 * err / scale).all()


@pytest.fixture(scope="module")
def binmul(tmp_path_factory):
    """The binmul packs of one fake layout, written by both CLIs: the JAX
    package's on its Pallas kernels (interpreted), the port's on the kernel
    backend's plain versions."""
    base = tmp_path_factory.mktemp("binmul")
    root = _fake_dcase_root(base / "dcase", 0)
    cache, jcache = str(base / "port"), str(base / "jax")
    args = ["--dcase-root", root, "--folds", "1", "2", "--binmul"]
    jax_feature.main(args + ["--cache-dir", jcache, "--backend", "pallas"])
    feature.main(args + ["--cache-dir", cache, "--backend", "kernel", "--device", "cpu"])
    return {"root": root, "cache": cache, "jcache": jcache, "args": args}


def test_binmul_cli_matches_jax(binmul):
    cache, jcache = binmul["cache"], binmul["jcache"]
    files = _per_file(cache, "binmul")
    assert files == _per_file(jcache, "binmul") and len(files) == 5
    for f in files:
        (x, y), (jx, jy) = (store.load_video_features(os.path.join(c, f))
                            for c in (cache, jcache))
        assert x.shape[1] == 240 and y.shape[1] == len(CLASSES)
        _assert_log_close(x, jx, 5e-4)
        np.testing.assert_array_equal(y, jy)
    _assert_packs_close(cache, jcache, (1, 2), "binmul", 5e-4)
    fold = store.load_fold(cache, 1, "binmul")
    assert abs(fold["train_x"].mean()) < 1e-3
    assert not np.allclose(fold["train_x"][:, :40], fold["train_x"][:, 40:80])


def test_binmul_rerun_touches_nothing(binmul):
    cache = binmul["cache"]
    log = os.path.join(cache, "feature_log.jsonl")
    assert len(open(log).read().splitlines()) == 5
    mtimes = {f: os.path.getmtime(os.path.join(cache, f)) for f in _per_file(cache, "binmul")}
    feature.main(binmul["args"] + ["--cache-dir", cache, "--backend", "kernel",
                                   "--device", "cpu"])
    assert {f: os.path.getmtime(os.path.join(cache, f)) for f in mtimes} == mtimes
    assert len(open(log).read().splitlines()) == 5


@pytest.mark.parametrize("binaural", [False, True])
def test_mono_and_binaural_packs_match_jax(tmp_path, binaural):
    root = _fake_dcase_root(tmp_path / "dcase", 1, binaural=binaural)
    cache, jcache = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["--dcase-root", root, "--folds", "1", "2"] + (["--binaural"] if binaural else [])
    jax_feature.main(args + ["--cache-dir", jcache])
    feature.main(args + ["--cache-dir", cache, "--device", "cpu"])
    tag = "bin" if binaural else "mon"
    for f in _per_file(cache, tag):
        x, y = store.load_video_features(os.path.join(cache, f))
        jx, jy = jax_store.load_video_features(os.path.join(jcache, f))
        assert x.shape[1] == (80 if binaural else 40)
        _assert_log_close(x, jx, 2e-4)
        np.testing.assert_array_equal(y, jy)
    _assert_packs_close(cache, jcache, (1, 2), tag, 2e-4)


def test_multires_cli_matches_jax(tmp_path):
    """`--multires 1024 2048` (implies binaural, overrides --binmul's set)
    through both CLIs: the same 4-map packs, features within 5e-4."""
    root = _fake_dcase_root(tmp_path / "dcase", 3)
    cache, jcache = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["--dcase-root", root, "--folds", "1", "--binmul", "--multires", "1024", "2048"]
    jax_feature.main(args + ["--cache-dir", jcache])
    feature.main(args + ["--cache-dir", cache, "--device", "cpu"])
    files = _per_file(cache, "binmul")
    assert files == _per_file(jcache, "binmul") and len(files) == 5
    for f in files:
        (x, y), (jx, jy) = (store.load_video_features(os.path.join(c, f)) for c in (cache, jcache))
        assert x.shape[1] == 4 * 40
        _assert_log_close(x, jx, 5e-4)
        np.testing.assert_array_equal(y, jy)
    _assert_packs_close(cache, jcache, (1,), "binmul", 5e-4)


def test_multires_requires_binaural(tmp_path):
    root = _fake_dcase_root(tmp_path / "dcase", 2, binaural=False)
    with pytest.raises(ValueError, match="binaural"):
        feature.extract_dcase(root, str(tmp_path / "c"), folds=(1,), binaural=False,
                              multires=(1024, 2048), device="cpu")


def _write_xlsx(path, header, rows):
    """Minimal xlsx, inline strings only."""
    def row_xml(r, values):
        cells = "".join(f'<c r="{chr(65 + c)}{r}" t="inlineStr"><is><t>{v}</t></is></c>'
                        for c, v in enumerate(values))
        return f'<row r="{r}">{cells}</row>'

    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    sheet = (f'<?xml version="1.0"?><worksheet {ns}><sheetData>' + row_xml(1, header)
             + "".join(row_xml(i + 2, r) for i, r in enumerate(rows))
             + "</sheetData></worksheet>")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("xl/worksheets/sheet1.xml", sheet)


def _decorte_layout(tmp_path, seed, n=5):
    rng = np.random.default_rng(seed)
    media = tmp_path / "media"
    media.mkdir()
    rows, assigns = ["filename,start,end"], []
    for i in range(n):
        name = f"clip{i:02d}.wav"
        wavio.write_wav(str(media / name), _noise_tones(rng, 2.0, channels=1)[:, 0], SR)
        rows += [f"{name},0.5,0.8", f"{name},1.2,1.6"]
        assigns += [[f"clip{i:02d}", "0.6", "A"], [f"clip{i:02d}", "1.3", "B"]]
    (media / "notes.txt").write_text("not media")
    hits = tmp_path / "hits.csv"
    hits.write_text("\n".join(rows) + "\n")
    xl = str(tmp_path / "assign.xlsx")
    _write_xlsx(xl, ["video", "timestamp", "player"], assigns)
    return str(media), str(hits), xl


def test_decorte_path_matches_jax(tmp_path):
    """Catalog (hits CSV + xlsx assignments, round-robin folds), features,
    labels and packs of `extract_decorte` against the JAX package's."""
    media, hits, xl = _decorte_layout(tmp_path, 3)
    cat = catalog.load_event_catalog(media, hits, xl, k_folds=4, verbose=False)
    jcat = jax_catalog.load_event_catalog(media, hits, xl, k_folds=4, verbose=False)
    assert [(e.name, e.events, e.assignments, e.fold_id) for e in cat.values()] == [
        (e.name, e.events, e.assignments, e.fold_id) for e in jcat.values()]
    assert xlsx.read_xlsx_rows(xl) == jax_xlsx.read_xlsx_rows(xl)
    cache, jcache = str(tmp_path / "port"), str(tmp_path / "jax")
    paths = feature.extract_decorte(media, hits, cache, xl, device="cpu")
    jpaths = jax_feature.extract_decorte(media, hits, jcache, xl)
    assert sorted(paths) == sorted(jpaths) == [1, 2, 3, 4]
    for f in _per_file(cache, "mon"):
        x, y = store.load_video_features(os.path.join(cache, f))
        jx, jy = jax_store.load_video_features(os.path.join(jcache, f))
        _assert_log_close(x, jx, 2e-4)
        np.testing.assert_array_equal(y, jy)
    _assert_packs_close(cache, jcache, (1, 2, 3, 4), "mon", 2e-4)
    with pytest.raises(catalog.CatalogError, match="monotonicity"):
        catalog.validate_monotone([1.0, 0.5], "x")


def test_stats_from_fold_legacy_refit_matches_jax(tmp_path, binmul):
    """A reference-style cache (per-video files, packs without arr_4/arr_5):
    the round-robin refit equals the JAX package's; a DCASE cache, whose
    labels are multi-class, is refused by both."""
    media, hits, _ = _decorte_layout(tmp_path, 4, n=6)
    cache = str(tmp_path / "cache")
    feature.extract_decorte(media, hits, cache, device="cpu")
    for k in (1, 2, 3, 4):
        os.remove(store.fold_path(cache, k))
        mean, scale = infer.stats_from_fold(cache, k, device="cpu")
        jmean, jscale = jax_infer.stats_from_fold(cache, k)
        np.testing.assert_allclose(mean, jmean, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(scale, jscale, rtol=1e-6)
    assert infer.stats_from_fold(str(tmp_path / "empty"), 1, device="cpu") is None
    dcase = str(tmp_path / "dcase_cache")
    os.makedirs(dcase)
    name = _per_file(binmul["cache"], "binmul")[0]
    x, y = store.load_video_features(os.path.join(binmul["cache"], name))
    store.save_video_features(os.path.join(dcase, name), x, y)
    for fn in (lambda: infer.stats_from_fold(dcase, 1, "binmul", device="cpu"),
               lambda: jax_infer.stats_from_fold(dcase, 1, "binmul")):
        with pytest.raises(ValueError, match="DCASE"):
            fn()


def test_binmul_packs_train_and_forward_matches_jax(tmp_path, binmul):
    """`run_fold` on the port's own binmul packs (sednet-dcase-binmul
    narrowed as the JAX package's pipeline test narrows it), and a forward
    of the 6-channel model on pack windows against the JAX model on the same
    converted weights."""
    fold = store.load_fold(binmul["cache"], 1, "binmul")
    cfg = get_preset("sednet-dcase-binmul")
    assert cfg.model.in_channels == 6
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, conv_channels=(4, 4, 4), gru_hidden=(4, 4),
                                  seq_len_in=64),
        train=dataclasses.replace(cfg.train, batch_size=2, max_epochs=1, plot_every=0))
    res = loop.run_fold(cfg, fold, 1, str(tmp_path / "art"), device="cpu", verbose=False)
    assert res.epochs_run == 1
    assert np.isfinite(res.history["loss_tr"][0]) and np.isfinite(res.history["loss_val"][0])

    jc, tc = narrowed("sednet-dcase-binmul")
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, 31)
    assert params["conv"][0]["w"].shape == (3, 3, 6, 8)
    model = port_model(tc, params, state)
    got_params, _ = to_jax(model.state_dict(), tc.model)
    for a, b in zip(jax.tree_util.tree_leaves(got_params), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert tuple(from_jax(params, state, tc.model)["conv.0.weight"].shape) == (8, 6, 3, 3)
    x = fold["train_x"][:256].reshape(1, 256, 240)
    want = jm.apply(params, state, x, Ctx(train=False))[0]
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("sr_in", [48000, 16000])
def test_resample_matches_jax(sr_in):
    x = np.random.default_rng(sr_in).standard_normal((sr_in // 4, 2)).astype(np.float32)
    got = resample.resample(x, sr_in, SR)
    want = jax_resample.resample(x, sr_in, SR)
    assert got.shape == want.shape == (int(np.ceil(x.shape[0] * SR / sr_in)), 2)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(resample.design_resample_filter(147, 160),
                                  jax_resample.design_resample_filter(147, 160))


def test_streaming_resampler_matches_offline():
    x = np.random.default_rng(5).standard_normal(9000).astype(np.float32)
    rs = resample.StreamingResampler(48000, SR)
    sizes = [0, 1, 7, 513, 64, 2048, 300]
    outs, i, k = [], 0, 0
    while i < len(x):
        outs.append(rs.push(x[i : i + sizes[k % len(sizes)]]))
        i, k = i + sizes[k % len(sizes)], k + 1
    outs.append(rs.flush())
    np.testing.assert_array_equal(np.concatenate(outs), resample.resample_poly(x, 147, 160))


def test_wav_readers_match_jax(tmp_path, monkeypatch):
    """A 48 kHz binaural wav: the multichannel reader, `decode_audio` with
    the resampler (mono and two channels), and the ffmpeg path without the
    binary, which both packages refuse."""
    p = str(tmp_path / "s48.wav")
    wavio.write_wav(p, _noise_tones(np.random.default_rng(6), 0.5, sr=48000), 48000)
    (x, sr), (jx, jsr) = wavio.read_wav_multichannel(p), jax_wavio.read_wav_multichannel(p)
    assert sr == jsr == 48000 and x.shape == (24000, 2)
    np.testing.assert_array_equal(x, jx)
    for mono in (True, False):
        got = wavio.decode_audio(p, sr=SR, mono=mono)
        np.testing.assert_allclose(got, jax_wavio.decode_audio(p, sr=SR, mono=mono), atol=1e-6)
        assert got.shape[0] == int(np.ceil(24000 * SR / 48000))
    monkeypatch.setattr(wavio.shutil, "which", lambda name: None)
    monkeypatch.setattr(jax_wavio.shutil, "which", lambda name: None)
    for mod in (wavio, jax_wavio):
        assert not mod.ffmpeg_available() and mod.probe_duration(p) is None
        assert mod.probe_media_meta(p) == {"fps": None, "n_frames": None, "width": None,
                                           "height": None, "duration_s": None}
        with pytest.raises(RuntimeError, match="ffmpeg"):
            mod.decode_audio(str(tmp_path / "clip.mp4"))


def test_feature_cli_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        feature.main(["--dcase-root", str(tmp_path), "--cache-dir", str(tmp_path / "c")])
