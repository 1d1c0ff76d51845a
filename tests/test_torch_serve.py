"""The port's live serving chain (`sed_crnn_torch/apps/serve.py`,
`utils/native.py`, `ops/frontend.py::log_mel_from_frames`) against the JAX
package's on the CPU, on the same PCM packets and weights.

The artifacts: the narrowed time-pooled shape of
`tests/test_export.py::_tiny_cfg` (16-frame chunks, one class), one JAX
artifact lowered for the CPU and the port's from the same weights, both
with folded statistics.

Tolerances: framing bitwise; log-mel rows within 5e-4 (the log-mel band);
probability lines within 2e-5; event lines identical, at thresholds placed
in the widest gap of the probabilities. Every wait has its own timeout.
"""

import dataclasses
import io
import json
import queue
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sed_crnn_tpu.apps import serve as jax_serve
from sed_crnn_tpu.core.config import FrontendConfig as JaxFrontendConfig
from sed_crnn_tpu.models import export as jax_export
from sed_crnn_tpu.models import get_model as jax_get_model
from sed_crnn_tpu.ops import frontend as jax_frontend
from sed_crnn_tpu.utils import native as jax_native

from sed_crnn_torch.apps import serve
from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.data import wavio
from sed_crnn_torch.models.export import export_serving
from sed_crnn_torch.ops import frontend
from sed_crnn_torch.utils.native import PythonFramer, make_framer
from tests.test_export import _tiny_cfg
from tests.test_torch_export import _gap_threshold
from tests.test_torch_model import port_config_of, seeded_tree

PROB_ATOL = 2e-5
LOGMEL_ATOL = 5e-4
WAIT_S = 60


def _packets(pcm, seed, lo=256, hi=8192):
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(pcm):
        step = int(rng.integers(lo, hi))
        yield pcm[i : i + step]
        i += step


def _noise(n, seed, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    jc = _tiny_cfg()
    tc = port_config_of(jc)
    params, state = seeded_tree(jax_get_model(jc.model), 200)
    rng = np.random.default_rng(201)
    stats = (rng.normal(-6.0, 1.0, 40).astype(np.float32),
             rng.uniform(1.0, 3.0, 40).astype(np.float32))
    jart = jax_export.export_serving(jc, params, state, norm_stats=stats, platforms=("cpu",))
    tart = export_serving(tc, params, state, norm_stats=stats, device="cpu")
    root = tmp_path_factory.mktemp("serve")
    jpath, tpath = str(root / "jax.sedart"), str(root / "torch.sedart")
    jart.save(jpath)
    tart.save(tpath)
    hop = jc.frontend.hop_length
    return SimpleNamespace(jc=jc, tc=tc, params=params, state=state, stats=stats, jart=jart,
                           tart=tart, jpath=jpath, tpath=tpath, root=root, hop=hop)


def _lines(run, *args, **kwargs):
    out = []
    n = run(*args, emit=out.append, **kwargs)
    return out, n


def _probs(lines):
    return np.concatenate([np.asarray(l["probs"]) for l in lines if l["type"] == "probs"])


def _events(lines):
    return [l for l in lines if l["type"] == "event"]


# ---- framer, PCM, decoder, log-mel rows ---------------------------------------

@pytest.mark.parametrize("n_fft,hop,center", [(512, 256, True), (2048, 1024, True),
                                              (400, 160, False)])
def test_framer_is_bitwise_jax_python_framer(n_fft, hop, center):
    pcm = _noise(30_000, n_fft)
    got, want = PythonFramer(n_fft, hop, center), jax_native.PythonFramer(n_fft, hop, center)
    for p in _packets(pcm, hop):
        a, b = got.feed(p), want.feed(p)
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.flush(), want.flush())
    assert isinstance(make_framer(n_fft, hop, center), PythonFramer)


def test_framer_is_bitwise_jax_native_framer():
    if not jax_native.native_available():
        pytest.skip("the JAX package's native framer needs g++")
    pcm = _noise(30_000, 7)
    got, want = PythonFramer(512, 256), jax_native.StreamingFramer(512, 256)
    parts_g, parts_w = [], []
    for p in _packets(pcm, 8):
        parts_g.append(got.feed(p))
        parts_w.append(want.feed(p))
    parts_g.append(got.flush())
    parts_w.append(want.flush())
    np.testing.assert_array_equal(np.concatenate(parts_g), np.concatenate(parts_w))


def test_framer_flush_guard():
    f = PythonFramer(512, 256)
    f.feed(np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="more than"):
        f.flush()
    with pytest.raises(RuntimeError, match="already flushed"):
        f.flush()
    with pytest.raises(RuntimeError, match="already flushed"):
        f.feed(np.zeros(10, np.float32))
    with pytest.raises(ValueError, match="invalid framer"):
        PythonFramer(0, 256)


def test_pcm_chunks_and_resampling_match_jax():
    x = _noise(1000, 9, scale=0.3)
    got = np.concatenate(list(serve.pcm_chunks_from_stream(io.BytesIO(x.tobytes()), "f32le",
                                                           chunk_bytes=333)))
    np.testing.assert_array_equal(got, x)
    s16 = (x * 32768.0).clip(-32768, 32767).astype("<i2").tobytes()
    got16 = list(serve.pcm_chunks_from_stream(io.BytesIO(s16), "s16le", chunk_bytes=101))
    want16 = list(jax_serve.pcm_chunks_from_stream(io.BytesIO(s16), "s16le", chunk_bytes=101))
    np.testing.assert_array_equal(np.concatenate(got16), np.concatenate(want16))
    with pytest.raises(ValueError, match="unknown pcm format"):
        list(serve.pcm_chunks_from_stream(io.BytesIO(b""), "u8"))
    pcm = _noise(20_000, 10)
    got = list(serve.resampled_chunks(_packets(pcm, 11), 48000, 44100))
    want = list(jax_serve.resampled_chunks(_packets(pcm, 11), 48000, 44100))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


def test_online_event_decoder_matches_jax():
    probs = np.random.default_rng(12).uniform(0, 1, (40, 3)).astype(np.float32)
    thr = np.asarray([0.5, 0.3, 0.7], np.float32)
    got_d, want_d = serve.OnlineEventDecoder(3, 0.1, thr), jax_serve.OnlineEventDecoder(3, 0.1, thr)
    got, want = [], []
    for i in range(0, 40, 7):
        got += got_d.push(probs[i : i + 7])
        want += want_d.push(probs[i : i + 7])
    assert got + got_d.finish() == want + want_d.finish()


@pytest.mark.parametrize("backend", ["fft", "matmul", "kernel"])
@pytest.mark.parametrize("log_floor", [None, 1e-10])
def test_log_mel_from_frames_matches_jax(backend, log_floor):
    frames = np.stack(list(PythonFramer(2048, 1024).feed(_noise(44100, 13))))
    frames[3] = 0.0                                   # a silent frame: -inf without a floor
    want = np.asarray(jax_frontend.log_mel_from_frames(
        frames, JaxFrontendConfig(log_floor=log_floor)))
    got = frontend.log_mel_from_frames(torch.from_numpy(frames),
                                       FrontendConfig(backend=backend, log_floor=log_floor))
    got = got.numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=LOGMEL_ATOL)
    with pytest.raises(ValueError, match="unknown frontend backend"):
        frontend.log_mel_from_frames(torch.from_numpy(frames), FrontendConfig(backend="pallas"))


# ---- serve_stream against the JAX chain ---------------------------------------

@pytest.mark.parametrize("lookahead", [False, True])
@pytest.mark.parametrize("tail", [10, 3])
def test_serve_stream_matches_jax(arts, lookahead, tail):
    """137 or 130 hops: a final ragged chunk of 10 or 3 frames."""
    pcm = _noise(arts.hop * (130 + tail - 3), 14)
    kw = dict(emit_probs=True, lookahead=lookahead)
    want, _ = _lines(jax_serve.serve_stream, arts.jart, _packets(pcm, 15), threshold=0.5, **kw)
    thr = _gap_threshold(_probs(want))[0]
    want, want_n = _lines(jax_serve.serve_stream, arts.jart, _packets(pcm, 15), threshold=thr, **kw)
    got, got_n = _lines(serve.serve_stream, arts.tart, _packets(pcm, 15), threshold=thr, **kw)
    assert got_n == want_n and got_n[1] > 0
    np.testing.assert_allclose(_probs(got), _probs(want), rtol=0, atol=PROB_ATOL)
    assert _events(got) == _events(want)
    assert [l["chunk"] for l in got if l["type"] == "probs"] == [
        l["chunk"] for l in want if l["type"] == "probs"]


def test_serve_stream_matches_offline_artifact(arts):
    """The live chain on the "kernel" frontend (the framed route's plain
    version here) against `extract` + `ServingArtifact.stream`."""
    tc = dataclasses.replace(arts.tc, frontend=dataclasses.replace(arts.tc.frontend,
                                                                   backend="kernel"))
    art = export_serving(tc, arts.params, arts.state, norm_stats=arts.stats, device="cpu")
    pcm = _noise(arts.hop * 137, 16)
    lines, (n_out, _) = _lines(serve.serve_stream, art, _packets(pcm, 17), emit_probs=True)
    fcfg = dataclasses.replace(tc.frontend, log_floor=1e-10)
    want = art.stream(frontend.extract(pcm, fcfg, device="cpu"))
    assert n_out == len(want)
    np.testing.assert_allclose(_probs(lines), want, rtol=0, atol=PROB_ATOL)


def test_serve_refuses_binaural_and_checks_thresholds(arts):
    jc = _tiny_cfg(in_channels=2, n_mels=8)
    tc = port_config_of(jc)
    params, state = seeded_tree(jax_get_model(jc.model), 202)
    binaural = export_serving(tc, params, state, device="cpu")
    with pytest.raises(ValueError, match="single-channel"):
        serve.serve_stream(binaural, iter([]), lambda _: None)
    with pytest.raises(ValueError, match="thresholds for"):
        serve.serve_stream(arts.tart, iter([]), lambda _: None,
                           threshold=np.asarray([0.2, 0.3], np.float32))


# ---- the batched worker ---------------------------------------------------------

def _run_with(art, pcm, stepper=None):
    lines, _ = _lines(serve.serve_stream, art, _packets(pcm, 18), threshold=0.5,
                      emit_probs=True, stepper=stepper)
    return _probs(lines)


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish in time"


def test_batched_worker_matches_single_stream(arts):
    streams = [_noise(44100 * 2, 20 + i) for i in range(3)]
    want = [_run_with(arts.tart, pcm) for pcm in streams]
    worker = serve.BatchedStepWorker(arts.tart, capacity=4)   # one slot stays idle
    got = [None] * 3

    def client(i):
        stepper = worker.stepper()
        try:
            got[i] = _run_with(arts.tart, streams[i], stepper)
        finally:
            stepper.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    _join(threads)
    worker.shutdown()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=PROB_ATOL)
    steps = [-(-len(w) // int(arts.tart.meta["seq_len_out"])) for w in want]
    assert worker.stepped == sum(steps)
    assert max(steps) <= worker.ticks <= worker.stepped


def test_batched_worker_slot_reuse_resets_state(arts):
    pcm = _noise(44100, 21)
    worker = serve.BatchedStepWorker(arts.tart, capacity=1)
    try:
        firsts = []
        for _ in range(2):
            stepper = worker.stepper()   # the same slot, zeroed on acquire
            try:
                firsts.append(_run_with(arts.tart, pcm, stepper))
            finally:
                stepper.close()
    finally:
        worker.shutdown()
    np.testing.assert_array_equal(firsts[0], firsts[1])


class _FakeArt:
    """A stand-in artifact whose batched step raises, or waits on a gate."""

    meta = {"seq_len_in": 4, "n_mels": 3, "in_channels": 1}
    device = torch.device("cpu")

    def __init__(self, fail=False):
        self.fail, self.gate, self.entered = fail, threading.Event(), threading.Event()

    def stream_init_batch(self, b):
        return [{"fwd": torch.zeros((b, 1, 2)), "bwd": torch.zeros((b, 1, 2))}]

    def stream_step_batch(self, carry, chunks):
        if self.fail:
            raise RuntimeError("kernel exploded")
        self.entered.set()
        assert self.gate.wait(WAIT_S)
        return carry, torch.zeros((chunks.shape[0], 4, 1))


def test_batched_worker_death_reaches_the_clients():
    w = serve.BatchedStepWorker(_FakeArt(fail=True), capacity=2)
    s = w.stepper()
    with pytest.raises(RuntimeError, match="died"):
        s.step(np.zeros((4, 3), np.float32))
    with pytest.raises(RuntimeError, match="shut down"):
        w.submit(0, np.zeros((4, 3), np.float32))
    with pytest.raises(RuntimeError, match="shut down"):
        w.acquire()
    w.shutdown()


def test_shutdown_answers_waiting_clients():
    """A client still waiting when the worker stops gets an error instead of
    blocking for ever."""
    art = _FakeArt()
    w = serve.BatchedStepWorker(art, capacity=2)
    results = {}

    def client(slot):
        try:
            results[slot] = w.submit(slot, np.zeros((4, 3), np.float32))
        except RuntimeError as e:
            results[slot] = e

    first = threading.Thread(target=client, args=(w.acquire(),))
    first.start()
    assert art.entered.wait(WAIT_S)                  # the worker is inside tick 1
    second = threading.Thread(target=client, args=(w.acquire(),))
    second.start()
    deadline = time.monotonic() + WAIT_S
    while not w._pending and time.monotonic() < deadline:
        time.sleep(0.01)
    assert w._pending, "the second chunk never arrived"
    stopper = threading.Thread(target=w.shutdown)
    stopper.start()
    while not w._stop and time.monotonic() < deadline:
        time.sleep(0.01)
    art.gate.set()                                   # tick 1 ends; then the worker stops
    _join([first, second, stopper])
    assert set(results) == {0, 1}
    got = sorted(results.items(), key=lambda kv: isinstance(kv[1], Exception))
    assert isinstance(got[0][1], np.ndarray)
    assert isinstance(got[1][1], RuntimeError) and "shut down" in str(got[1][1])


def test_failing_acquire_closes_the_socket():
    w = serve.BatchedStepWorker(_FakeArt(), capacity=1)
    w.shutdown()
    a, b = socket.socketpair()
    with b:
        b.settimeout(WAIT_S)
        serve.handle_connection(a, "test", lambda conn, stepper: pytest.fail("served"), w)
        assert a.fileno() == -1
        assert b.recv(1) == b""                      # the peer sees the close


# ---- the CLI ----------------------------------------------------------------------

def test_serve_cli_wav_matches_jax(arts, tmp_path):
    pcm = _noise(44100 * 2, 22)
    wav = str(tmp_path / "live.wav")
    wavio.write_wav(wav, pcm, 44100)
    common = ["--wav", wav, "--emit", "both", "--class-names", "bird"]
    probe, _ = _lines(jax_serve.serve_stream, arts.jart, jax_serve.pcm_chunks_from_wav(wav, 44100),
                      threshold=0.5, emit_probs=True)
    thr = str(_gap_threshold(_probs(probe))[0])
    jax_serve.main(["--artifact", arts.jpath, *common, "--threshold", thr,
                    "--out", str(tmp_path / "j.jsonl")])
    assert serve.main(["--artifact", arts.tpath, *common, "--threshold", thr,
                       "--out", str(tmp_path / "t.jsonl"), "--device", "cpu"]) is None
    want, got = ([json.loads(l) for l in (tmp_path / f).read_text().splitlines()]
                 for f in ("j.jsonl", "t.jsonl"))
    assert _events(got) == _events(want) and _events(got)
    assert all(l["label"] == "bird" for l in _events(got))
    np.testing.assert_allclose(_probs(got), _probs(want), rtol=0, atol=PROB_ATOL)
    summary = got[-1]
    assert summary["type"] == "summary" and summary["n_output_frames"] == len(_probs(got))
    assert summary["n_events"] == want[-1]["n_events"] and "step_ms_p99" in summary


def _free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _client(port, pcm, out, i):
    deadline = time.monotonic() + WAIT_S
    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=1)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    with s:
        s.settimeout(WAIT_S)
        s.sendall(pcm.tobytes())
        s.shutdown(socket.SHUT_WR)
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    out[i] = [json.loads(l) for l in data.decode().splitlines()]


def test_listen_daemon_serves_concurrent_clients(arts):
    """--listen with --max-streams 4: three clients at once, each given the
    single-stream output; the daemon returns its tick counts."""
    streams = [_noise(44100, 30 + i) for i in range(3)]

    def single(thr):
        return [_lines(serve.serve_stream, arts.tart, iter([pcm]), threshold=thr,
                       emit_probs=True)[0] for pcm in streams]

    thr = _gap_threshold(np.concatenate([_probs(w) for w in single(0.5)]))[0]
    want = single(thr)
    port = _free_port()
    result = queue.SimpleQueue()
    daemon = threading.Thread(target=lambda: result.put(serve.main([
        "--artifact", arts.tpath, "--pcm", "f32le", "--listen", str(port), "--connections", "3",
        "--max-streams", "4", "--emit", "both", "--threshold", str(thr), "--device", "cpu"])),
        daemon=True)
    daemon.start()
    out = [None] * 3
    clients = [threading.Thread(target=_client, args=(port, pcm, out, i))
               for i, pcm in enumerate(streams)]
    for t in clients:
        t.start()
    _join(clients + [daemon])
    counts = result.get(timeout=1)
    steps = [sum(l["type"] == "probs" for l in w) for w in want]     # one line per chunk
    assert counts["served"] == 3 and counts["stepped"] == sum(steps)
    assert max(steps) <= counts["ticks"] <= sum(steps)
    for got, w in zip(out, want):
        assert got[-1]["type"] == "summary" and "step_ms_p50" in got[-1]
        np.testing.assert_allclose(_probs(got), _probs(w), rtol=0, atol=PROB_ATOL)
        assert [{k: v for k, v in e.items() if k != "label"} for e in _events(got)] == _events(w)


@pytest.mark.parametrize("argv", [
    ["--pcm", "f32le", "--max-streams", "4"],                       # without --listen
    ["--pcm", "f32le", "--listen", "0", "--max-streams", "4", "--lookahead"],
    ["--pcm", "f32le", "--listen", "0", "--max-streams", "0"],
    ["--pcm", "f32le", "--input-rate", "0"],
    ["--pcm", "f32le", "--input-rate", "-16000"],
    ["--wav", "x.wav", "--input-rate", "16000"],
    ["--wav", "x.wav", "--listen", "0"],
])
def test_serve_cli_validates_flags(arts, argv):
    with pytest.raises(SystemExit):
        serve.main(["--artifact", arts.tpath, "--device", "cpu", *argv])
