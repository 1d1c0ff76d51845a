"""The port's host-side event scoring against the JAX package's: event
metrics (`ops/event_metrics.py`), event-list files (`data/eventio.py`), the
scoring tool (`apps/score_events.py`) and the sequence helpers
(`data/seqs.py`). Both packages run the same algorithms in Python, so every
result must be identical, not close: score dicts compared through their
JSON text (NaN included), files byte for byte, arrays exactly.
"""

import json

import numpy as np
import pytest

from sed_crnn_tpu.apps import score_events as jax_score
from sed_crnn_tpu.data import eventio as jax_eventio
from sed_crnn_tpu.data import seqs as jax_seqs
from sed_crnn_tpu.ops import event_metrics as jax_em

from sed_crnn_torch.apps import score_events
from sed_crnn_torch.data import eventio, seqs
from sed_crnn_torch.ops import event_metrics as em


def _same(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _scene(rng, crowded):
    """Random reference and system events over 3 classes; ``crowded``
    packs them inside a few collars."""
    span = 1.5 if crowded else 20.0

    def mk(n):
        out = []
        for _ in range(n):
            on = float(rng.uniform(0, span))
            out.append((on, on + float(rng.uniform(0.05, 1.5)), int(rng.integers(0, 3))))
        return out

    return mk(int(rng.integers(0, 12))), mk(int(rng.integers(0, 12)))


@pytest.mark.parametrize("matching", ["optimal", "greedy"])
def test_event_scores_match_jax_on_random_scenes(matching):
    rng = np.random.default_rng(11)
    for case in range(200):
        ref, sys = _scene(rng, crowded=case % 2 == 0)
        kw = dict(t_collar=float(rng.choice([0.05, 0.2, 0.5])),
                  offset_condition=bool(rng.integers(0, 2)),
                  offset_collar_frac=float(rng.choice([0.2, 0.5])), matching=matching)
        _same(em.event_scores(ref, sys, **kw), jax_em.event_scores(ref, sys, **kw))
    with pytest.raises(ValueError, match="matching"):
        em.event_scores([], [], matching="hungarian")


def test_long_collar_chains_without_recursion():
    """A 5,000-event collar chain whose one augmenting path runs through
    every event (5,001 references, right k held by left k, the last left
    eligible only for right 0): a recursive search would overflow the
    stack. The matcher's assignment equals the JAX one. Then the JAX
    package's own 1,500-event chain through `event_scores`."""
    n = 5000
    adj = [[k, k + 1] for k in range(n)] + [[0]]
    got = em._max_bipartite(adj, n + 1)
    assert got[0] == n + 1
    assert got == jax_em._max_bipartite(adj, n + 1)
    assert em._greedy_match(adj, n + 1) == jax_em._greedy_match(adj, n + 1)
    n = 1500
    ref = [(0.05 * i, 0.05 * i + 0.04, 0) for i in range(n)]
    sys = [(0.05 * i + 0.01, 0.05 * i + 0.05, 0) for i in range(n)]
    got = em.event_scores(ref, sys)
    assert got["tp"] == n and got["er_event"] == 0.0
    _same(got, jax_em.event_scores(ref, sys))


def test_class_wise_aggregate_and_roll_scores_match_jax():
    rng = np.random.default_rng(12)
    scenes = [_scene(rng, crowded=bool(i % 2)) for i in range(6)]
    per_file, jper_file = [], []
    for ref, sys in scenes:
        for n_classes in (None, 4):
            _same({str(k): v for k, v in em.class_wise_event_scores(
                      ref, sys, n_classes=n_classes, matching="greedy").items()},
                  {str(k): v for k, v in jax_em.class_wise_event_scores(
                      ref, sys, n_classes=n_classes, matching="greedy").items()})
        per_file.append(em.event_scores(ref, sys))
        jper_file.append(jax_em.event_scores(ref, sys))
    _same(em.aggregate_event_scores(per_file), jax_em.aggregate_event_scores(jper_file))

    hop = 1024 / 44100
    pred = rng.random((400, 3)).astype(np.float32)
    ref_roll = (rng.random((400, 3)) > 0.8).astype(np.float32)
    for th in (0.5, np.asarray([0.3, 0.6, 0.9], np.float32)):
        assert em.events_from_roll(pred, hop, th) == jax_em.events_from_roll(pred, hop, th)
        _same(em.event_scores_from_rolls(pred, ref_roll, hop, th, t_collar=0.1),
              jax_em.event_scores_from_rolls(pred, ref_roll, hop, th, t_collar=0.1))


def test_event_list_writers_are_byte_identical(tmp_path):
    events = [(2.5, 3.1, 1), (0.25, 1.0, 0), (0.2500004, 1.0, 1), (0.2500001, 0.9999996, 0),
              (7.0, 7.5, 2)]
    names = ("hit", "car", "people walking")
    for kw in ({}, {"class_names": names}, {"class_names": names, "filename": "a001.wav"}):
        evs = events if "class_names" in kw else [(s, e, names[c]) for s, e, c in events]
        got = eventio.write_event_list(str(tmp_path / "p.txt"), evs, **kw)
        want = jax_eventio.write_event_list(str(tmp_path / "j.txt"), evs, **kw)
        assert open(got, "rb").read() == open(want, "rb").read()
    assert eventio.format_event_list([]) == jax_eventio.format_event_list([]) == ""
    with pytest.raises(ValueError, match="outside"):
        eventio.format_event_list([(0.0, 1.0, 5)], names)
    for n in (1, 6, 3):
        assert eventio.default_class_names(n) == jax_eventio.default_class_names(n)


def test_event_list_readers_match_jax(tmp_path):
    p = tmp_path / "mixed.txt"
    p.write_text(
        "# a comment\n"
        "1.5 2.0\n"                                      # 2 columns, whitespace
        "0.5\t1.0\tcar\n"                                # 3 columns
        "a001.wav\t2.0\t3.0\tchildren\n"                 # 4 columns with a file
        "7\t1.0\t2.0\t5\n"                               # numeric filename and label
        "1.0\t2.0\tcar\textra\n"                         # onset offset label extra
        "audio/street/a001.wav\tstreet\t2.33\t4.77\tcar\tm\ta001.ann\n"   # TUT meta
        "audio/street/a002.wav street 0.50 1.00 people\n"
        "\n"
    )
    rows = eventio.read_event_list(str(p))
    assert rows == jax_eventio.read_event_list(str(p))
    assert rows[0] == (None, 1.5, 2.0, "0") and rows[3] == ("7", 1.0, 2.0, "5")
    by_file = eventio.events_by_file(rows)
    assert by_file == jax_eventio.events_by_file(rows)
    names = ("car", "children")
    assert eventio.map_labels(by_file["a001.wav"], names) == jax_eventio.map_labels(
        by_file["a001.wav"], names) == [(2.0, 3.0, 1)]
    for mod in (eventio, jax_eventio):
        with pytest.raises(ValueError, match="unknown event label"):
            mod.map_labels([(0.0, 1.0, "truck")], names)
    bad = tmp_path / "bad.txt"
    bad.write_text("0.5\t1.0\tcar\nstreet\tcar\tx\n")
    for mod in (eventio, jax_eventio):
        with pytest.raises(ValueError, match=r"bad.txt:2: no onset/offset"):
            mod.read_event_list(str(bad))


def test_score_event_lists_and_cli_match_jax(tmp_path, capsys):
    ref, est = tmp_path / "ref.txt", tmp_path / "est.txt"
    ref.write_text("a.wav\t1.0\t2.0\tcar\na.wav\t4.0\t5.0\tcar\nb.wav\t0.0\t1.0\thit\n"
                   "c.wav\t3.0\t3.5\tcar\n")
    est.write_text("a.wav\t1.1\t2.0\tcar\na.wav\t7.0\t8.0\tcar\nb.wav\t0.05\t1.0\tcar\n"
                   "d.wav\t0.0\t1.0\thit\n")
    for kw in ({}, {"t_collar": 0.05}, {"offset_condition": True, "matching": "greedy"}):
        _same(score_events.score_event_lists(str(ref), str(est), **kw),
              jax_score.score_event_lists(str(ref), str(est), **kw))
    args = ["--ref", str(ref), "--est", str(est), "--per-file", "--collar", "0.1"]
    score_events.main(args)
    got = capsys.readouterr().out
    jax_score.main(args)
    assert got == capsys.readouterr().out and json.loads(got)["n_files"] == 4
    score_events.main(args + ["--out", str(tmp_path / "p.json")])
    jax_score.main(args + ["--out", str(tmp_path / "j.json")])
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()

    plain = tmp_path / "plain.txt"
    plain.write_text("1.0\t2.0\tcar\n")
    for fn in (score_events.score_event_lists, jax_score.score_event_lists):
        with pytest.raises(ValueError, match="filename"):
            fn(str(ref), str(plain))


def test_seqs_match_jax():
    rng = np.random.default_rng(13)
    a = rng.standard_normal((5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(seqs.reshape_3d_to_2d(a), jax_seqs.reshape_3d_to_2d(a))
    feats = rng.standard_normal((3, 16, 80)).astype(np.float32)
    got = seqs.split_multi_channels(feats, 2)
    assert got.shape == (3, 2, 16, 40) and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, jax_seqs.split_multi_channels(feats, 2))
    for bad in ((feats[0], 2), (feats, 3)):
        for mod in (seqs, jax_seqs):
            with pytest.raises(ValueError):
                mod.split_multi_channels(*bad)
    for x in (rng.standard_normal(1001), rng.standard_normal((1001, 6)),
              rng.standard_normal((1001, 2, 3))):
        got = seqs.split_in_seqs(x, 256)
        assert got.shape[:2] == (3, 256)
        np.testing.assert_array_equal(got, jax_seqs.split_in_seqs(x, 256))
