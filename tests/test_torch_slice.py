"""The serving slice end to end on the CPU: the port's streaming and the
`apps/infer.py` composition against the JAX package (GRU on its XLA scan) on
the same seeded weights and waveform, plus the port's ground rules (no
import of jax or sed_crnn_tpu; entry points refuse to fall back to the CPU).

Tolerances: probabilities within 1e-4 absolute (float32 frontends and
models of two frameworks, features normalized to unit scale); event lists
equal.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from sed_crnn_tpu.apps import infer as jax_infer
from sed_crnn_tpu.core import checkpoint as jax_ckpt
from sed_crnn_tpu.data import wavio as jax_wavio
from sed_crnn_tpu.data.rasterize import events_from_labels as jax_events
from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.models.streaming import stream_probabilities as jax_stream
from sed_crnn_tpu.ops import frontend as jax_frontend

from sed_crnn_torch.apps import evaluate as evaluate_app
from sed_crnn_torch.apps import export as export_app
from sed_crnn_torch.apps import infer
from sed_crnn_torch.apps import serve as serve_app
from sed_crnn_torch.core.config import get_preset
from sed_crnn_torch.data import wavio
from sed_crnn_torch.data.rasterize import events_from_labels
from sed_crnn_torch.models.export import ServingArtifact, export_serving
from sed_crnn_torch.models.streaming import stream_probabilities
from sed_crnn_torch.ops import frontend
from sed_crnn_torch.train.evaluate import evaluate_split
from sed_crnn_torch.train.multiseed import run_experiment_multiseed
from tests.test_torch_model import narrowed, port_model, seeded_tree

REPO = pathlib.Path(__file__).resolve().parents[1]
PROB_ATOL = 1e-4


def _wav(path, seconds, seed, sr=44100):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = 0.02 * rng.standard_normal(t.size)
    for k, f in enumerate((440.0, 1200.0, 3000.0)):
        on = (np.floor(t / 1.5) % 3) == k          # bursts of 1.5 s in turn
        y = y + on * 0.3 * np.sin(2 * np.pi * f * t)
    wavio.write_wav(str(path), y.astype(np.float32), sr)
    return str(path)


@pytest.mark.parametrize("lookahead,carry_backward", [(False, False), (False, True), (True, False)])
def test_stream_probabilities_match_jax(lookahead, carry_backward):
    jc, tc = narrowed("sednet-dcase")
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, 20)
    model = port_model(tc, params, state)
    mel = np.random.default_rng(21).standard_normal((600, 40)).astype(np.float32)
    want = jax_stream(jm, params, state, mel, carry_backward, lookahead=lookahead)
    got = stream_probabilities(model, torch.from_numpy(mel), carry_backward, lookahead=lookahead)
    assert got.shape == want.shape == (600, 6)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)


@pytest.mark.parametrize("n_frames", [0, 3])
def test_stream_short_inputs_match_jax(n_frames):
    """No frames at all, and less than one chunk: same shapes and values."""
    jc, tc = narrowed("sednet-dcase")
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, 29)
    mel = np.random.default_rng(30).standard_normal((n_frames, 40)).astype(np.float32)
    want = jax_stream(jm, params, state, mel)
    got = stream_probabilities(port_model(tc, params, state), torch.from_numpy(mel))
    assert got.shape == want.shape == (n_frames, 6)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)


def test_infer_composition_matches_jax(tmp_path):
    """decode -> extract -> normalize -> stream -> events, narrowed sednet."""
    path = _wav(tmp_path / "a.wav", 8.0, 22)
    jc, tc = narrowed("sednet-dcase")
    jfe = dataclasses.replace(jc.frontend, log_floor=1e-10)
    tfe = dataclasses.replace(tc.frontend, log_floor=1e-10)
    jm = jax_get_model(jc.model)
    params, state = seeded_tree(jm, 23)
    model = port_model(tc, params, state)

    jmel = jax_frontend.extract(jax_wavio.decode_audio(path, 44100), jfe)
    stats = (jmel.mean(axis=0), jmel.std(axis=0) + 1.0)
    want = jax_stream(jm, params, state, (jmel - stats[0]) / stats[1])
    mel = frontend.extract(wavio.decode_audio(path, 44100), tfe, device="cpu")
    got = stream_probabilities(model, frontend.normalize(mel, stats))
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    assert events_from_labels(got, 44100, 1024, 0.5) == jax_events(want, 44100, 1024, 0.5)


def test_infer_file_full_preset_matches_jax(tmp_path):
    """`infer_file` on a JAX-written full-width sednet-dcase checkpoint."""
    path = _wav(tmp_path / "b.wav", 6.0, 24)
    jm = jax_get_model("sednet-dcase")
    params, state = seeded_tree(jm, 25)
    ckpt = jax_ckpt.save_checkpoint(
        str(tmp_path / "c.npz"), {"params": params, "model_state": state}, {"epoch": 4})
    stats = (np.full(40, -4.0, np.float32), np.full(40, 3.0, np.float32))
    want, want_ev, want_meta = jax_infer.infer_file(path, ckpt, "sednet-dcase", stats, median=3)
    got, got_ev, got_meta = infer.infer_file(path, ckpt, "sednet-dcase", stats, median=3,
                                             device="cpu")
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    assert got_ev == want_ev and got_meta == want_meta == {"epoch": 4}


def test_infer_main_writes_dcase_rows(tmp_path, capsys):
    path = _wav(tmp_path / "m.wav", 3.0, 26)
    params, state = seeded_tree(jax_get_model("timepooled-v1"), 27)
    ckpt = jax_ckpt.save_checkpoint(str(tmp_path / "m.npz"),
                                    {"params": params, "model_state": state})
    infer.main(["--wav", path, "--checkpoint", ckpt, "--preset", "timepooled-v1",
                "--threshold", "0.0", "--format", "dcase", "--device", "cpu"])
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows and all(r.endswith("\thit") for r in rows)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "sed_crnn_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    assert {f"sed_crnn_torch/{m}.py" for m in (
        "apps/feature", "data/catalog", "data/xlsx", "data/resample", "data/wavio",
        "data/store", "ops/kernels/fused_logmel", "train/evaluate", "apps/evaluate",
        "apps/score_events", "ops/event_metrics", "data/eventio", "data/seqs",
        "train/multiseed", "models/export", "apps/export", "apps/serve",
        "utils/native")} <= scanned
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "sed_crnn_tpu")]
    assert bad == []


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frontend.extract(np.zeros(4096, np.float32), get_preset("sednet-dcase").frontend)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.infer_file(_wav(tmp_path / "d.wav", 0.5, 28), "unused.npz", "sednet-dcase")
    jc, tc = narrowed("timepooled-v1")
    model = port_model(tc, *seeded_tree(jax_get_model(jc.model), 32))
    x, y = np.zeros((128, 40), np.float32), np.zeros((128, 1), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_split(model, x, y, tc)
    np.savez(str(tmp_path / "mbe_mon_fold1.npz"), x, y, x, y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_app.main(["--checkpoint", "unused.npz", "--cache-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_experiment_multiseed(tc, {1: {"train_x": x, "train_y": y, "val_x": x, "val_y": y}},
                                 str(tmp_path / "runs"), n_runs=2)


def test_serving_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The artifact's load and export, `infer_file_artifact`, and the export
    and serve CLIs run on the CPU only when asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jc, tc = narrowed("timepooled-v1")
    params, state = seeded_tree(jax_get_model(jc.model), 33)
    path = str(tmp_path / "m.sedart")
    export_serving(tc, params, state, device="cpu").save(path)
    assert ServingArtifact.load(path, device="cpu").device.type == "cpu"
    wav = _wav(tmp_path / "e.wav", 0.5, 34)
    ckpt = jax_ckpt.save_checkpoint(str(tmp_path / "e.npz"),
                                    {"params": params, "model_state": state})
    for call in (
        lambda: ServingArtifact.load(path),
        lambda: export_serving(tc, params, state),
        lambda: infer.infer_file_artifact(wav, path),
        lambda: infer.main(["--wav", wav, "--artifact", path]),
        lambda: export_app.main(["--checkpoint", ckpt, "--out", str(tmp_path / "o.sedart")]),
        lambda: serve_app.main(["--artifact", path, "--wav", wav]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
