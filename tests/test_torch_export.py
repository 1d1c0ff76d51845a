"""The port's serving artifact (`sed_crnn_torch/models/export.py`,
`apps/export.py`, `apps/infer.py --artifact`) against the JAX package's on
the CPU, from the same weights.

Two configurations, one JAX artifact each (module fixture, the JAX programs
lowered for the CPU): the narrowed time-pooled shape of
`tests/test_export.py::_tiny_cfg` and a narrowed `sednet-dcase` (mel-pooled,
reset_after=False, 8 conv channels, BiGRU(8) x 2), both with folded
normalization statistics.

Tolerances: the programs' probabilities and carry leaves within 2e-5
(float32 products and convolutions of two frameworks); carry shapes equal;
the CLI's probabilities within 1e-4 (two frontends' log-mels, as
`tests/test_torch_slice.py`) and its events identical, at thresholds placed
in the widest gap of the probabilities so that no frame sits at an edge.
"""

import json
import zipfile
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from sed_crnn_tpu.apps import export as jax_export_app
from sed_crnn_tpu.apps import infer as jax_infer
from sed_crnn_tpu.core import checkpoint as jax_ckpt
from sed_crnn_tpu.models import export as jax_export
from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.models.streaming import stream_logits_batch as jax_stream_logits_batch
from sed_crnn_tpu.train.evaluate import stack_trees as jax_stack_trees

from sed_crnn_torch.apps import export as export_app
from sed_crnn_torch.apps import infer
from sed_crnn_torch.data import wavio
from sed_crnn_torch.models.export import (
    FORMAT,
    ServingArtifact,
    export_serving,
    export_tf_savedmodel,
    stack_trees,
)
from sed_crnn_torch.models.streaming import stream_logits_batch
from tests.test_export import _tiny_cfg
from tests.test_torch_model import narrowed, port_config_of, port_model, seeded_tree

ATOL = 2e-5
CLI_PROB_ATOL = 1e-4
CONFIGS = ("timepooled", "sednet")


def _configs(name):
    if name == "timepooled":
        jc = _tiny_cfg()
        return jc, port_config_of(jc)
    return narrowed("sednet-dcase")


def _stats(feat, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(feat).astype(np.float32),
            (0.5 + rng.random(feat)).astype(np.float32))


@pytest.fixture(scope="module", params=CONFIGS)
def case(request):
    jc, tc = _configs(request.param)
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, 40)
    feat = jc.model.n_mels * jc.model.in_channels
    stats = _stats(feat, 41)
    return SimpleNamespace(
        name=request.param, jc=jc, tc=tc, jm=jm, params=params, state=state, stats=stats,
        feat=feat, T=jc.model.seq_len_in,
        jart=jax_export.export_serving(jc, params, state, norm_stats=stats, platforms=("cpu",)),
        tart=export_serving(tc, params, state, norm_stats=stats, device="cpu"),
    )


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _carry_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"fwd", "bwd"}
        for d in ("fwd", "bwd"):
            assert tuple(g[d].shape) == tuple(np.shape(w[d]))
            _close(g[d], w[d])


@pytest.mark.parametrize("batch", [1, 3])
def test_forward_matches_jax(case, batch):
    x = _x((batch, case.T, case.feat), batch)
    _close(case.tart.forward(x), case.jart.forward(x))


@pytest.mark.parametrize("lookahead", [False, True])
def test_stream_matches_jax(case, lookahead):
    mel = _x((3 * case.T + 7, case.feat), 5)     # padding and trim of a ragged tail
    got = case.tart.stream(mel, lookahead=lookahead)
    assert isinstance(got, np.ndarray)
    _close(got, case.jart.stream(mel, lookahead=lookahead))


def test_stream_step_matches_jax(case):
    jc, tc = case.jart.stream_init(), case.tart.stream_init()
    _carry_close(tc, jc)
    for k in range(3):
        chunk = _x((case.T, case.feat), 10 + k)
        jc, jp = case.jart.stream_step(jc, chunk)
        tc, tp = case.tart.stream_step(tc, chunk)
        _close(tp, jp)
        _carry_close(tc, jc)


def test_stream_step_lookahead_matches_jax(case):
    jc, tc = case.jart.stream_init(), case.tart.stream_init()
    for k in range(2):
        pair = _x((2 * case.T, case.feat), 20 + k)
        jc, jp = case.jart.stream_step_lookahead(jc, pair)
        tc, tp = case.tart.stream_step_lookahead(tc, pair)
        _close(tp, jp)
        _carry_close(tc, jc)


def test_stream_step_batch_matches_jax(case):
    jc, tc = case.jart.stream_init_batch(3), case.tart.stream_init_batch(3)
    _carry_close(tc, jc)
    for k in range(2):
        chunks = _x((3, case.T, case.feat), 30 + k)
        jc, jp = case.jart.stream_step_batch(jc, chunks)
        tc, tp = case.tart.stream_step_batch(tc, chunks)
        _close(tp, jp)
        _carry_close(tc, jc)


def test_normalization_is_folded(case):
    plain = export_serving(case.tc, case.params, case.state, device="cpu")
    assert case.tart.meta["norm_folded"] and not plain.meta["norm_folded"]
    x = _x((2, case.T, case.feat), 50)
    mean, scale = case.stats
    _close(case.tart.forward(x), plain.forward((x - mean) / scale).numpy(), atol=1e-6)


def test_stream_logits_batch_matches_jax(case):
    model = port_model(case.tc, case.params, case.state)
    mels = _x((3, 2 * case.T + 5, case.feat), 60)
    want = jax_stream_logits_batch(case.jm, case.params, case.state, mels)
    got = stream_logits_batch(model, torch.from_numpy(mels))
    _close(got, want)


def test_ensemble_matches_jax():
    jc, tc = _configs("timepooled")
    jm = jax_get_model(jc.model)
    trees = [seeded_tree(jm, s) for s in (70, 71)]
    params = jax_stack_trees([p for p, _ in trees])
    state = jax_stack_trees([s for _, s in trees])
    params, state = (jax.tree.map(np.asarray, t) for t in (params, state))
    stats = _stats(jc.model.n_mels, 72)
    jart = jax_export.export_serving(jc, params, state, norm_stats=stats, platforms=("cpu",),
                                     ensemble_members=2)
    tart = export_serving(tc, params, state, norm_stats=stats, ensemble_members=2,
                          device="cpu")
    assert len(tart.models) == 2 and tart.meta["ensemble_members"] == 2
    T, feat = jc.model.seq_len_in, jc.model.n_mels
    x = _x((3, T, feat), 73)
    _close(tart.forward(x), jart.forward(x))
    for lookahead in (False, True):
        mel = _x((3 * T + 7, feat), 74)
        _close(tart.stream(mel, lookahead=lookahead), jart.stream(mel, lookahead=lookahead))
    jcar, tcar = jart.stream_init(), tart.stream_init()
    _carry_close(tcar, jcar)                                   # (2, 1, H) leaves
    jcar, jp = jart.stream_step(jcar, x[0])
    tcar, tp = tart.stream_step(tcar, x[0])
    _close(tp, jp)
    _carry_close(tcar, jcar)
    jb, tb = jart.stream_init_batch(3), tart.stream_init_batch(3)
    _carry_close(tb, jb)                                       # (3, 2, 1, H) leaves
    jb, jp = jart.stream_step_batch(jb, x)
    tb, tp = tart.stream_step_batch(tb, x)
    _close(tp, jp)
    _carry_close(tb, jb)
    # the members' own artifacts, averaged
    single = [export_serving(tc, p, s, norm_stats=stats, device="cpu") for p, s in trees]
    _close(tart.forward(x), sum(a.forward(x) for a in single).numpy() / 2, atol=1e-6)


def test_stack_trees_matches_jax():
    jm = jax_get_model(_tiny_cfg().model)
    trees = [seeded_tree(jm, s)[0] for s in (80, 81)]
    want = jax_stack_trees(trees)
    got = stack_trees(trees)
    flat_w = jax_ckpt._flatten(jax.tree.map(np.asarray, want))
    flat_g = jax_ckpt._flatten(got)
    assert flat_w.keys() == flat_g.keys()
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k])


def test_meta_has_every_jax_key(case):
    jm, tm = case.jart.meta, case.tart.meta
    assert set(tm) == set(jm)
    assert tm["format"] == FORMAT and tm["platforms"] == ["cuda", "cpu"]
    for k in set(jm) - {"format", "platforms", "model", "frontend"}:
        assert tm[k] == jm[k], k
    assert set(tm["model"]) == set(jm["model"]) and set(tm["frontend"]) == set(jm["frontend"])
    assert {k: v for k, v in tm["model"].items() if k != "gru_backend"} == {
        k: v for k, v in jm["model"].items() if k != "gru_backend"}
    assert tm["model"]["gru_backend"] == "auto" and tm["frontend"] == jm["frontend"]


def test_save_load_round_trip_is_bitwise(case, tmp_path):
    path = str(tmp_path / "m.sedart")
    case.tart.save(path)
    back = ServingArtifact.load(path, device="cpu")
    assert back.meta == case.tart.meta
    for a, b in zip(back.norm_stats, case.tart.norm_stats):
        np.testing.assert_array_equal(a, b)
    flat_a, flat_b = (jax_ckpt._flatten(t) for t in (back.tree, case.tart.tree))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])
    x = _x((2, case.T, case.feat), 90)
    assert torch.equal(back.forward(x), case.tart.forward(x))
    (_, pa), (_, pb) = (a.stream_step(a.stream_init(), x[0]) for a in (back, case.tart))
    assert torch.equal(pa, pb)
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["meta.json", "norm.npz", "weights.npz"]


def test_load_refuses_jax_artifacts_and_other_files(tmp_path):
    jc = _tiny_cfg()
    params, state = seeded_tree(jax_get_model(jc.model), 95)
    jpath = str(tmp_path / "jax.sedart")
    jax_export.export_serving(jc, params, state, platforms=("cpu",)).save(jpath)
    with pytest.raises(ValueError, match="sed_crnn_torch.apps.export"):
        ServingArtifact.load(jpath, device="cpu")
    bogus = tmp_path / "bogus.sedart"
    bogus.write_bytes(b"not a zip at all")
    with pytest.raises(ValueError, match="not a serving artifact"):
        ServingArtifact.load(str(bogus), device="cpu")
    other = str(tmp_path / "other.sedart")
    with zipfile.ZipFile(other, "w") as zf:
        zf.writestr("meta.json", json.dumps({"format": "something-else"}))
    with pytest.raises(ValueError, match="artifact"):
        ServingArtifact.load(other, device="cpu")
    # the TF export refuses, before tensorflow loads, an ensemble whose
    # weights carry no member axis
    tc = port_config_of(jc)
    with pytest.raises(ValueError, match="member axis of 2"):
        export_tf_savedmodel(tc, params, state, str(tmp_path / "tf"), ensemble_members=2)


@pytest.mark.parametrize("threshold,want", [(0.999, 0.999), ([0.4], [0.4]), (None, None)])
def test_default_threshold_recorded_as_jax(threshold, want):
    jc, tc = _configs("timepooled")
    params, state = seeded_tree(jax_get_model(jc.model), 96)
    art = export_serving(tc, params, state, default_threshold=threshold, device="cpu")
    assert art.meta["default_threshold"] == want
    with pytest.raises(ValueError, match="default thresholds"):
        export_serving(tc, params, state, default_threshold=[0.3, 0.7], device="cpu")


def _gap_threshold(probs):
    """Per class, the midpoint of the widest gap between the sorted
    probabilities in their upper half: a threshold no frame sits near."""
    out = []
    for p in np.sort(np.asarray(probs, np.float64), axis=0).T:
        hi = p[len(p) // 2:]
        i = int(np.argmax(np.diff(hi)))
        out.append(float((hi[i] + hi[i + 1]) / 2))
    return out


def _wav(path, seconds, seed, sr=44100):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = 0.05 * rng.standard_normal(t.size) + ((np.floor(t) % 2) == 0) * 0.3 * np.sin(
        2 * np.pi * 880 * t)
    wavio.write_wav(str(path), y.astype(np.float32), sr)
    return str(path)


def test_export_and_infer_clis_match_jax(tmp_path, capsys):
    """apps.export against the JAX CLI (the same JSON keys and values but
    the platforms), then apps.infer --artifact on each CLI's artifact:
    probabilities within 1e-4 and identical events, at the baked threshold
    and at one given on the command line."""
    jc, tc = _configs("timepooled")
    params, state = seeded_tree(jax_get_model(jc.model), 97)
    ckpt = jax_ckpt.save_checkpoint(str(tmp_path / "best.npz"),
                                    {"params": params, "model_state": state}, {"epoch": 7})
    stats = _stats(jc.model.n_mels, 98)
    cache = tmp_path / "cache"
    cache.mkdir()
    x = np.zeros((4, jc.model.n_mels), np.float32)
    y = np.zeros((4, 1), np.float32)
    np.savez(str(cache / "mbe_mon_fold1.npz"), x, y, x, y, *stats)
    wav = _wav(tmp_path / "x.wav", 4.0, 99)

    jart = jax_export.export_serving(jc, params, state, norm_stats=stats, platforms=("cpu",))
    probs, _, _ = jax_infer.infer_file_artifact(wav, _save(jart, tmp_path / "probe.sedart"))
    thr = _gap_threshold(probs)

    common = ["--checkpoint", ckpt, "--stats-from", str(cache), "--threshold", str(thr[0])]
    jpath, tpath = str(tmp_path / "jax.sedart"), str(tmp_path / "torch.sedart")
    with mock.patch("sed_crnn_tpu.core.config.get_preset", return_value=jc):
        jax_export_app.main([*common, "--out", jpath, "--platforms", "cpu"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with mock.patch.object(export_app, "get_preset", return_value=tc):
        got = export_app.main([*common, "--out", tpath, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == set(want)
    for k in set(want) - {"artifact", "bytes", "platforms"}:
        assert got[k] == want[k], k
    assert got["default_threshold"] == thr[0] and got["norm_folded"]

    for extra in ([], ["--threshold", "0.0"]):
        jax_infer.main(["--wav", wav, "--artifact", jpath, "--out", str(tmp_path / "j.json"),
                        *extra])
        infer.main(["--wav", wav, "--artifact", tpath, "--out", str(tmp_path / "t.json"),
                    "--device", "cpu", *extra])
        capsys.readouterr()
        j, t = (json.loads((tmp_path / f).read_text()) for f in ("j.json", "t.json"))
        assert t == j and (t["events"] or extra)
    got_p, got_ev, meta = infer.infer_file_artifact(wav, tpath, device="cpu")
    want_p, want_ev, _ = jax_infer.infer_file_artifact(wav, jpath)
    _close(got_p, want_p, atol=CLI_PROB_ATOL)
    assert got_ev == want_ev and meta["preset"] == "timepooled-v1"

    for argv in ([], ["--artifact", tpath, "--checkpoint", ckpt]):
        with pytest.raises(SystemExit):
            infer.main(["--wav", wav, "--device", "cpu", *argv])
    with pytest.raises(SystemExit):
        export_app.main(["--checkpoint", ckpt, "--out", tpath, "--format", "tf",
                         "--threshold", "0.5"])
    empty = tmp_path / "empty"
    empty.mkdir()
    with mock.patch.object(export_app, "get_preset", return_value=tc), pytest.raises(SystemExit):
        export_app.main(["--checkpoint", ckpt, "--out", tpath, "--device", "cpu",
                         "--stats-from", str(empty)])


def test_export_cli_takes_an_ensemble(tmp_path, capsys):
    jc, tc = _configs("timepooled")
    jm = jax_get_model(jc.model)
    ckpts = []
    for s in (100, 101):
        params, state = seeded_tree(jm, s)
        ckpts.append(jax_ckpt.save_checkpoint(
            str(tmp_path / f"c{s}.npz"), {"params": params, "model_state": state}, {"epoch": s}))
    out = str(tmp_path / "ens.sedart")
    with mock.patch.object(export_app, "get_preset", return_value=tc):
        got = export_app.main(["--checkpoint", *ckpts, "--out", out, "--device", "cpu"])
    capsys.readouterr()
    assert got["ensemble_members"] == 2
    assert got["checkpoint_meta"] == {"members": [{"epoch": 100}, {"epoch": 101}]}
    art = ServingArtifact.load(out, device="cpu")
    x = _x((2, jc.model.seq_len_in, jc.model.n_mels), 102)
    singles = [export_serving(tc, *seeded_tree(jm, s), device="cpu") for s in (100, 101)]
    _close(art.forward(x), sum(a.forward(x) for a in singles).numpy() / 2, atol=1e-6)


def _save(art, path):
    art.save(str(path))
    return str(path)
