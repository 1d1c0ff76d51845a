"""Live serving daemon: a PCM stream in, detections out, from a serving
artifact alone.

The live counterpart of `apps/infer.py --artifact`: PCM packets of any size
(a microphone, a socket, ffmpeg's stdout) enter the streaming framer
(`utils/native.py`), complete frames become log-mel rows
(`ops/frontend.py::log_mel_from_frames`: on the artifact's ``"kernel"``
frontend, kernel A's framed route, one launch per framer block), and every
``seq_len_in`` rows one `stream_step` of the artifact advances the carried
GRU state and gives frame probabilities. Events open and close online: one
JSON line per event as soon as its offset is known (plus probability lines
with ``--emit probs|both``). The same chain as the offline pipeline: the
final ragged chunk is zero-padded and trimmed as `ServingArtifact.stream`
does.

  ffmpeg -i rtsp://cam -f f32le -ac 1 -ar 44100 - | \\
      python -m sed_crnn_torch.apps.serve --artifact model.sedart --pcm f32le
  python -m sed_crnn_torch.apps.serve --artifact model.sedart --wav recording.wav
  python -m sed_crnn_torch.apps.serve --artifact model.sedart --pcm s16le --listen 7700

``--listen PORT`` accepts TCP connections instead of reading stdin: each
connection streams PCM in and gets its own JSON lines back on the same
socket, with fresh state (``--connections N``, 0 = forever). ``--max-streams
B`` serves up to B clients at once: each tick, one worker thread gathers
whatever chunks are waiting into one ``stream_step_batch``
(`BatchedStepWorker`), so N clients cost one dispatch per tick, kernel B at
B rows. Summaries report the per-step latency p50/p99, timed to the host
copy of the probabilities. Runs on ``--device cuda`` by default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue
import socket
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from sed_crnn_torch.apps.infer import _threshold_arg
from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.data.eventio import default_class_names
from sed_crnn_torch.data.resample import StreamingResampler
from sed_crnn_torch.data.wavio import decode_audio
from sed_crnn_torch.models.export import ServingArtifact
from sed_crnn_torch.ops.frontend import log_mel_from_frames
from sed_crnn_torch.utils.native import make_framer


def pcm_chunks_from_stream(stream, fmt: str = "f32le", chunk_bytes: int = 65536):
    """Byte stream -> float32 PCM chunks. ``f32le`` passes through;
    ``s16le`` scales by 1/32768. Carries split samples across reads."""
    if fmt not in ("f32le", "s16le"):
        raise ValueError(f"unknown pcm format {fmt!r}: use f32le or s16le")
    width = 4 if fmt == "f32le" else 2
    pending = b""
    while True:
        data = stream.read(chunk_bytes)
        if not data:
            break
        data = pending + data
        usable = len(data) - len(data) % width
        pending = data[usable:]
        if not usable:
            continue
        if fmt == "f32le":
            yield np.frombuffer(data[:usable], "<f4").astype(np.float32)
        else:
            yield np.frombuffer(data[:usable], "<i2").astype(np.float32) / 32768.0


def resampled_chunks(chunks, sr_in: int, sr_out: int):
    """A PCM chunk stream at ``sr_in`` at ``sr_out``, on the fly, through the
    carried-history polyphase resampler (`data/resample.py`): the
    concatenated output equals resampling the whole stream offline."""
    rs = StreamingResampler(sr_in, sr_out)
    for chunk in chunks:
        out = rs.push(chunk)
        if out.size:
            yield out
    tail = rs.flush()
    if tail.size:
        yield tail


def pcm_chunks_from_wav(path: str, sr: int, chunk_samples: int = 8192):
    pcm = decode_audio(path, sr=sr, mono=True)
    for i in range(0, len(pcm), chunk_samples):
        yield pcm[i : i + chunk_samples]


class OnlineEventDecoder:
    """Threshold-crossing event tracker over streamed probability chunks:
    emits each event once, when its offset frame arrives (or at the end of
    the stream for events still open)."""

    def __init__(self, n_classes: int, frame_hop_s: float, threshold):
        self.thr = np.broadcast_to(np.asarray(threshold, np.float32), (n_classes,)).copy()
        self.hop_s = frame_hop_s
        self.open = [None] * n_classes  # onset frame index per class
        self.frame = 0

    def push(self, probs: np.ndarray):
        """(frames, n_classes) probabilities -> completed events
        ``(onset_s, offset_s, class)``."""
        done = []
        active = np.asarray(probs) > self.thr[None, :]
        for row in active:
            for c, a in enumerate(row):
                if a and self.open[c] is None:
                    self.open[c] = self.frame
                elif not a and self.open[c] is not None:
                    done.append((self.open[c] * self.hop_s, self.frame * self.hop_s, c))
                    self.open[c] = None
            self.frame += 1
        return done

    def finish(self):
        done = [(s * self.hop_s, self.frame * self.hop_s, c)
                for c, s in enumerate(self.open) if s is not None]
        self.open = [None] * len(self.open)
        return done


class _DirectStepper:
    """Single-stream stepping straight through the artifact's programs: owns
    the carried state and the per-step latencies."""

    def __init__(self, artifact: ServingArtifact):
        self.art = artifact
        self.carry = artifact.stream_init()
        self.latencies = []

    def _timed(self, program, x) -> np.ndarray:
        t0 = time.perf_counter()
        self.carry, probs = program(self.carry, x)
        probs = probs.cpu().numpy()   # the host copy waits for the card
        self.latencies.append(time.perf_counter() - t0)
        return probs

    def step(self, chunk) -> np.ndarray:
        return self._timed(self.art.stream_step, chunk)

    def step_lookahead(self, chunk_pair) -> np.ndarray:
        return self._timed(self.art.stream_step_lookahead, chunk_pair)

    def close(self):
        pass


class _ShutDown(RuntimeError):
    """A call on a `BatchedStepWorker` that is shut down."""


def _leaves(carry):
    return [c[d] for c in carry for d in sorted(c)]


class BatchedStepWorker:
    """Multiplexes up to ``capacity`` concurrent live streams through one
    ``stream_step_batch`` per tick (`models/export.py`).

    Each connection owns a slot; its handler thread submits one log-mel chunk
    at a time and blocks for that slot's probabilities. One worker thread
    gathers whatever chunks are waiting, zero-pads the idle slots, runs the
    batched step (kernel B at ``capacity`` rows) and hands each slot its
    rows. The carry stays on the artifact's device: the step's new carry is
    written back into the active slots only, so idle slots keep theirs, and
    a newly acquired slot is zeroed. A worker failure reaches every waiting
    client as an exception; `shutdown` answers every waiting client."""

    def __init__(self, artifact, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.art = artifact
        self.capacity = capacity
        meta = artifact.meta
        self._zero = torch.zeros(
            (int(meta["seq_len_in"]), int(meta["n_mels"]) * int(meta["in_channels"])),
            device=artifact.device)
        self.carry = artifact.stream_init_batch(capacity)
        self._free = list(range(capacity))
        self._pending = {}  # slot -> (chunk, reply SimpleQueue)
        self._ticking = []  # the replies of the tick being stepped
        self._cv = threading.Condition()
        self._stop = False
        self._error: Exception | None = None
        self.ticks = 0
        self.stepped = 0
        self._thread = threading.Thread(target=self._run, name="sed-serve-batch-step",
                                        daemon=True)
        self._thread.start()

    def stepper(self) -> "_SlotStepper":
        return _SlotStepper(self)

    def acquire(self) -> int:
        with self._cv:
            while not self._free and not self._stop:
                self._cv.wait()
            if self._stop:
                raise _ShutDown("batched step worker is shut down") from self._error
            slot = self._free.pop()
            for leaf in _leaves(self.carry):
                leaf[slot] = 0  # fresh stream state
            return slot

    def release(self, slot: int) -> None:
        with self._cv:
            self._pending.pop(slot, None)
            self._free.append(slot)
            self._cv.notify_all()

    def submit(self, slot: int, chunk) -> np.ndarray:
        chunk = torch.as_tensor(chunk, dtype=torch.float32, device=self._zero.device)
        reply: "queue.SimpleQueue" = queue.SimpleQueue()
        with self._cv:
            if self._stop:
                raise _ShutDown("batched step worker is shut down") from self._error
            self._pending[slot] = (chunk, reply)
            self._cv.notify_all()
        out = reply.get()
        if isinstance(out, _ShutDown):
            raise out
        if isinstance(out, BaseException):
            raise RuntimeError("batched step worker died") from out
        return out

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10)

    def _run(self) -> None:
        try:
            self._loop()
        except Exception as e:  # deliver it: no client may wait on a dead worker
            print(f"batched step worker died: {e!r}", file=sys.stderr, flush=True)
            with self._cv:    # stopped before any client hears of it
                self._error = e
                self._stop = True
                waiting = self._ticking + [reply for _, reply in self._pending.values()]
                self._pending.clear()
                self._cv.notify_all()
            for reply in waiting:
                reply.put(e)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop:
                    for _, reply in self._pending.values():
                        reply.put(_ShutDown("batched step worker is shut down"))
                    self._pending.clear()
                    return
                batch = dict(self._pending)
                self._pending.clear()
            slots = sorted(batch)
            self._ticking = [batch[s][1] for s in slots]   # answered by _run on a failure
            chunks = torch.stack([batch[s][0] if s in batch else self._zero
                                  for s in range(self.capacity)])
            new_carry, probs = self.art.stream_step_batch(self.carry, chunks)
            probs = probs.cpu().numpy()
            with self._cv:
                for old, new in zip(_leaves(self.carry), _leaves(new_carry)):
                    idx = torch.as_tensor(slots, device=old.device)
                    old[idx] = new[idx]  # idle slots keep their carry
            self.ticks += 1
            self.stepped += len(slots)
            self._ticking = []
            for s in slots:
                batch[s][1].put(probs[s])


class _SlotStepper:
    """One stream's view of a `BatchedStepWorker` slot."""

    def __init__(self, worker: BatchedStepWorker):
        self.worker = worker
        self.slot = worker.acquire()
        self.latencies = []

    def step(self, chunk) -> np.ndarray:
        t0 = time.perf_counter()
        probs = self.worker.submit(self.slot, chunk)
        self.latencies.append(time.perf_counter() - t0)
        return probs

    def step_lookahead(self, chunk_pair):
        raise ValueError(
            "lookahead is unsupported in batched serving mode: it holds chunks "
            "across ticks; serve lookahead streams single-stream"
        )

    def close(self):
        self.worker.release(self.slot)


def serve_stream(
    artifact: ServingArtifact,
    pcm_chunks,
    emit,
    threshold=None,
    log_floor: float = 1e-10,
    emit_probs: bool = False,
    emit_events: bool = True,
    lookahead: bool = False,
    stepper=None,
):
    """Drive the live chain; calls ``emit(dict)`` per output line. Returns
    ``(n_output_frames, n_events)``.

    ``lookahead=True`` holds each chunk until its successor arrives and runs
    the artifact's pair steps: one chunk of right context at one chunk of
    latency, the output of ``artifact.stream(lookahead=True)``."""
    meta = artifact.meta
    if int(meta.get("in_channels", 1)) != 1:
        raise ValueError(
            f"live serving is single-channel; the artifact was exported with "
            f"in_channels={meta['in_channels']}: serve binaural recordings offline "
            f"with sed_crnn_torch.apps.infer --artifact"
        )
    fcfg = FrontendConfig(**meta["frontend"])
    if log_floor:
        fcfg = dataclasses.replace(fcfg, log_floor=float(log_floor))
    n_classes = int(meta["n_classes"])
    chunk_frames = int(meta["seq_len_in"])
    pool = chunk_frames // int(meta["seq_len_out"])
    out_hop_s = fcfg.hop_length * pool / fcfg.sample_rate
    if threshold is None:
        threshold = meta.get("default_threshold")
        if threshold is None:
            threshold = 0.5
    threshold = _threshold_arg(threshold, n_classes)

    framer = make_framer(fcfg.n_fft, fcfg.hop_length, fcfg.center)
    decoder = OnlineEventDecoder(n_classes, out_hop_s, threshold)
    if stepper is None:
        stepper = _DirectStepper(artifact)
    dev = artifact.device
    buf = torch.empty((0, fcfg.n_mels), device=dev)   # log-mel rows not yet stepped
    n_out = n_events = chunk_i = 0
    pending = None  # lookahead: the chunk awaiting its right context

    def run_chunk(chunk, keep_frames, right=None):
        nonlocal n_out, n_events, chunk_i
        if right is None:
            probs = stepper.step(chunk)
        else:
            probs = stepper.step_lookahead(torch.cat([chunk, right]))
        probs = probs[:keep_frames]
        n_out += probs.shape[0]
        if emit_probs and probs.shape[0]:
            emit({"type": "probs", "chunk": chunk_i, "probs": np.round(probs, 5).tolist()})
        if emit_events:
            for s, e, c in decoder.push(probs):
                n_events += 1
                emit({"type": "event", "start_s": round(s, 3), "end_s": round(e, 3),
                      "class": c})
        chunk_i += 1

    def consume(chunk, keep_frames):
        nonlocal pending
        if not lookahead:
            run_chunk(chunk, keep_frames)
        else:
            if pending is not None:
                run_chunk(pending[0], pending[1], right=chunk)
            pending = (chunk, keep_frames)

    def add_rows(frames):
        nonlocal buf
        if frames.shape[0]:
            rows = log_mel_from_frames(torch.from_numpy(frames).to(dev), fcfg)
            buf = torch.cat([buf, rows])
        while buf.shape[0] >= chunk_frames:
            consume(buf[:chunk_frames], chunk_frames // pool)
            buf = buf[chunk_frames:]

    for pcm in pcm_chunks:
        add_rows(framer.feed(pcm))
    # End of stream: the framer's right-pad tail frames, then the final
    # ragged chunk, zero-padded to a full chunk and trimmed to its true
    # output frames as the offline `ServingArtifact.stream` pads and trims,
    # then the events still open (their offset is the end of the stream).
    add_rows(framer.flush())
    # A ragged tail of fewer than ``pool`` frames emits nothing itself, but
    # under lookahead it is still the held chunk's real right context, as
    # the offline padding provides it.
    if buf.shape[0] >= (1 if lookahead else pool):
        consume(F.pad(buf, (0, 0, 0, chunk_frames - buf.shape[0])), buf.shape[0] // pool)
    if lookahead and pending is not None:
        run_chunk(pending[0], pending[1], right=torch.zeros_like(pending[0]))
    if emit_events:
        for s, e, c in decoder.finish():
            n_events += 1
            emit({"type": "event", "start_s": round(s, 3), "end_s": round(e, 3), "class": c,
                  "open_at_eos": True})
    return n_out, n_events


def handle_connection(conn: socket.socket, addr, run, worker=None) -> None:
    """Serve one TCP connection: ``run(conn, stepper)`` streams its PCM in and
    its JSON lines back (``stepper`` None: single-stream stepping). With a
    ``worker``, its slot is taken inside the ``with conn`` block, so a
    failing acquire closes the socket; a dropped client or a failed worker
    ends this connection and not the daemon."""
    with conn:
        stepper = None
        try:
            stepper = worker.stepper() if worker is not None else None
            run(conn, stepper)
        except (ConnectionError, OSError, RuntimeError) as e:
            print(f"connection from {addr} dropped: {e!r}", file=sys.stderr, flush=True)
        finally:
            if stepper is not None:
                stepper.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", required=True, help="artifact from sed_crnn_torch.apps.export")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--pcm", choices=("f32le", "s16le"),
                     help="read raw mono PCM of this format from stdin (at the artifact's "
                          "frontend rate, or give --input-rate to resample live)")
    src.add_argument("--wav", help="serve a wav file through the live chain")
    p.add_argument("--listen", type=int, metavar="PORT",
                   help="with --pcm: accept TCP connections on HOST:PORT instead of "
                        "reading stdin; JSON lines return on the socket")
    p.add_argument("--host", default="127.0.0.1", help="bind address for --listen")
    p.add_argument("--connections", type=int, default=1,
                   help="with --listen: serve N connections then exit (0 = forever)")
    p.add_argument("--max-streams", type=int, default=1, metavar="B",
                   help="with --listen: serve up to B clients concurrently through one "
                        "batched step per tick; 1 = one connection at a time")
    p.add_argument("--threshold", type=float, nargs="+", default=None,
                   help="one global value or one per class (default: the artifact's "
                        "default_threshold, else 0.5)")
    p.add_argument("--emit", choices=("events", "probs", "both"), default="events")
    p.add_argument("--input-rate", type=int, metavar="HZ",
                   help="with --pcm: the incoming stream's sample rate; resampled live "
                        "to the artifact's frontend rate when they differ")
    p.add_argument("--lookahead", action="store_true",
                   help="hold each chunk one chunk for bounded bidirectional right "
                        "context (+seq_len_in frames of latency)")
    p.add_argument("--class-names", help="comma-separated labels added to event lines")
    p.add_argument("--log-floor", type=float, default=1e-10)
    p.add_argument("--out", help="append JSON lines here (default stdout)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    if args.input_rate is not None and not args.pcm:
        p.error("--input-rate applies to --pcm streams; wav files carry their own rate "
                "and are resampled automatically")
    # A zero or negative rate would otherwise raise at the first chunk, inside
    # a connection's handler, and never reach the user.
    if args.input_rate is not None and args.input_rate <= 0:
        p.error("--input-rate must be a positive Hz value")
    if args.max_streams < 1:
        p.error("--max-streams must be >= 1")
    if args.max_streams > 1 and args.listen is None:
        p.error("--max-streams applies to --listen daemons")
    if args.max_streams > 1 and args.lookahead:
        p.error("--lookahead is single-stream; drop it or --max-streams")
    if args.listen is not None and not args.pcm:
        p.error("--listen requires --pcm FORMAT (raw PCM over TCP)")

    art = ServingArtifact.load(args.artifact, args.device)
    n_classes = int(art.meta["n_classes"])
    names = (tuple(args.class_names.split(",")) if args.class_names
             else default_class_names(n_classes))
    if len(names) != n_classes:
        p.error(f"{len(names)} class names for {n_classes} classes")
    threshold = None
    if args.threshold is not None:
        threshold = (args.threshold[0] if len(args.threshold) == 1
                     else np.asarray(args.threshold, np.float32))
    art_sr = int(art.meta["frontend"]["sample_rate"])

    def make_emit(sink):
        def emit(obj):
            if obj.get("type") == "event":
                obj = {**obj, "label": names[obj["class"]]}
            sink.write(json.dumps(obj) + "\n")
            sink.flush()
        return emit

    def adapt_rate(chunks):
        if args.input_rate is None or args.input_rate == art_sr:
            return chunks
        return resampled_chunks(chunks, args.input_rate, art_sr)

    def run_one(chunks, emit, stepper=None):
        stepper = stepper if stepper is not None else _DirectStepper(art)
        n_out, n_events = serve_stream(
            art, chunks, emit, threshold, args.log_floor,
            emit_probs=args.emit in ("probs", "both"),
            emit_events=args.emit in ("events", "both"),
            lookahead=args.lookahead, stepper=stepper,
        )
        summary = {"type": "summary", "n_output_frames": n_out, "n_events": n_events}
        if stepper.latencies:
            lat = np.asarray(stepper.latencies) * 1e3
            summary["step_ms_p50"] = round(float(np.percentile(lat, 50)), 2)
            summary["step_ms_p99"] = round(float(np.percentile(lat, 99)), 2)
        emit(summary)

    if args.listen is None:
        sink = open(args.out, "a") if args.out else sys.stdout
        try:
            chunks = (pcm_chunks_from_wav(args.wav, art_sr) if args.wav
                      else adapt_rate(pcm_chunks_from_stream(sys.stdin.buffer, args.pcm)))
            run_one(chunks, make_emit(sink))
        finally:
            if args.out:
                sink.close()
        return None

    def run_connection(conn, stepper):
        with conn.makefile("rb") as rf, conn.makefile("w") as wf:
            run_one(adapt_rate(pcm_chunks_from_stream(rf, args.pcm)), make_emit(wf), stepper)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((args.host, args.listen))
        srv.listen(max(8, args.max_streams))
        print(f"listening on {args.host}:{srv.getsockname()[1]}"
              + (f" (batched, up to {args.max_streams} concurrent streams)"
                 if args.max_streams > 1 else ""), file=sys.stderr, flush=True)
        served = 0
        if args.max_streams == 1:
            while args.connections == 0 or served < args.connections:
                conn, addr = srv.accept()
                handle_connection(conn, addr, run_connection)
                served += 1
            return {"served": served}
        worker = BatchedStepWorker(art, args.max_streams)
        try:
            handlers = []
            while args.connections == 0 or served < args.connections:
                conn, addr = srv.accept()
                # each handler takes its slot itself, so a full house queues new
                # clients instead of blocking the accept loop
                t = threading.Thread(target=handle_connection,
                                     args=(conn, addr, run_connection, worker), daemon=True)
                t.start()
                handlers.append(t)
                served += 1
            for t in handlers:
                t.join()
        finally:
            worker.shutdown()
        print(f"served {served} connections in {worker.ticks} batched ticks "
              f"({worker.stepped} chunk steps)", file=sys.stderr, flush=True)
        return {"served": served, "ticks": worker.ticks, "stepped": worker.stepped}
    finally:
        srv.close()


if __name__ == "__main__":
    main()
