"""The port's segment metrics and threshold sweeps (`ops/metrics.py`)
against the JAX package's on identical binarized and probability inputs:
`compute_scores`, `class_wise_scores`, `class_wise_report`,
`threshold_sweep`, `best_threshold`, `threshold_sweep_per_class` and
`best_per_class_thresholds` (both objectives, the absent-class
false-positive tie-break).

Cases: a partial tail block, an empty reference, a class absent from the
reference, a class positive only in the dropped tail, 3-D inputs, one class,
probabilities equal to thresholds, float64 thresholds. Tolerances: counts
and chosen thresholds equal; ratios within 1e-6 with NaN and inf in the
same places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.ops import metrics as jax_metrics

from sed_crnn_torch.ops import metrics

RATIO_ATOL = 1e-6
THRESHOLDS = np.round(np.arange(0.05, 0.96, 0.05), 3).astype(np.float32)


def _case(name):
    """(probabilities, targets, block) of a named case, from a numpy seed."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "tail":          # 1000 frames at 43 per block: a partial tail block
        n, c, block = 1000, 6, 43
    elif name == "empty_ref":   # no reference at all: ER NaN or inf everywhere
        n, c, block = 200, 3, 10
    elif name == "one_class":
        n, c, block = 300, 1, 7
    else:                       # "3d": (N, T, C) inputs
        n, c, block = 4 * 64, 2, 5
    p = rng.random((n, c)).astype(np.float32)
    p[::17] = 0.5                           # ties with the 0.5 threshold
    p[5::19] = np.float32(0.3)              # and with a float32 sweep point
    t = (rng.random((n, c)) < 0.15).astype(np.float32)
    # smooth the targets into runs so that blocks are mixed
    t = np.maximum(t, np.roll(t, 1, axis=0))
    if name == "empty_ref":
        t[:] = 0
    if name == "tail":
        t[:, 2] = 0                         # absent class
        t[:, 4] = 0
        t[-5:, 4] = 1                       # positive only in the dropped tail
        p[:, 2] = np.where(p[:, 2] > 0.9, p[:, 2], 0.0)   # few false positives
    if name == "3d":
        p, t = p.reshape(4, 64, c), t.reshape(4, 64, c)
    return p, t, block


CASES = ["tail", "empty_ref", "one_class", "3d"]


def _close(got, want):
    got = np.asarray(got.cpu() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=RATIO_ATOL, equal_nan=True)


@pytest.mark.parametrize("name", CASES)
def test_compute_and_class_wise_scores_match_jax(name):
    p, t, block = _case(name)
    o = (p > 0.5).astype(np.float32)
    ot, tt, oj, tj = torch.from_numpy(o), torch.from_numpy(t), jnp.asarray(o), jnp.asarray(t)
    got, want = metrics.compute_scores(ot, tt, block), jax_metrics.compute_scores(oj, tj, block)
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k], want[k])
    # only false positives against an empty reference: the unguarded ER is inf
    assert np.isinf(float(got["er_overall_1sec"])) == (name == "empty_ref")
    for g, w in zip(metrics.class_wise_scores(ot, tt, block),
                    jax_metrics.class_wise_scores(oj, tj, block)):
        _close(g, w)
    got, want = metrics.class_wise_report(ot, tt, block), jax_metrics.class_wise_report(oj, tj,
                                                                                         block)
    assert got["present"] == want["present"]
    for k in ("f1_1s", "er_1s"):
        assert [v is None for v in got[k]] == [v is None for v in want[k]]
        _close([v for v in got[k] if v is not None], [v for v in want[k] if v is not None])
    if name == "tail":
        assert want["present"] == [True, True, False, True, False, True]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("th_dtype", [np.float32, np.float64])
def test_threshold_sweeps_match_jax(name, th_dtype):
    p, t, block = _case(name)
    ths = THRESHOLDS.astype(th_dtype)
    pt, tt = torch.from_numpy(p), torch.from_numpy(t)
    for g, w in zip(metrics.threshold_sweep(pt, tt, ths, block),
                    jax_metrics.threshold_sweep(jnp.asarray(p), jnp.asarray(t), jnp.asarray(ths),
                                                block)):
        assert g.shape == (len(ths),)
        _close(g, w)
    got = metrics.best_threshold(pt, tt, ths, block)
    want = jax_metrics.best_threshold(jnp.asarray(p), jnp.asarray(t), ths, block)
    assert float(got["threshold"]) == float(want["threshold"])
    for k in ("er", "f1", "all_f1", "all_er"):
        _close(got[k], want[k])
    for g, w in zip(metrics.threshold_sweep_per_class(pt, tt, ths, block),
                    jax_metrics.threshold_sweep_per_class(jnp.asarray(p), jnp.asarray(t),
                                                          jnp.asarray(ths, jnp.float32), block)):
        assert g.shape == (len(ths), p.shape[-1])
        _close(g, w)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("objective", ["er", "f1"])
def test_best_per_class_thresholds_match_jax(name, objective):
    p, t, block = _case(name)
    got = metrics.best_per_class_thresholds(torch.from_numpy(p), torch.from_numpy(t), THRESHOLDS,
                                            block, objective)
    want = jax_metrics.best_per_class_thresholds(jnp.asarray(p), jnp.asarray(t), THRESHOLDS,
                                                 block, objective)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["thresholds"].numpy(), np.asarray(want["thresholds"]))
    np.testing.assert_array_equal(got["class_present"].numpy(), np.asarray(want["class_present"]))
    for k in ("er", "f1", "class_f1", "class_er", "all_f1", "all_er"):
        _close(got[k], want[k])
    if name == "tail":
        # absent classes take the threshold of fewest false-positive blocks
        fps = metrics.threshold_sweep_per_class(torch.from_numpy(p), torch.from_numpy(t),
                                                THRESHOLDS, block)[2]
        for c in (2, 4):
            i = int(np.flatnonzero(THRESHOLDS == float(got["thresholds"][c]))[0])
            assert float(fps[i, c]) == float(fps[:, c].min())
    with pytest.raises(ValueError, match="objective"):
        metrics.best_per_class_thresholds(torch.from_numpy(p), torch.from_numpy(t), THRESHOLDS,
                                          block, "auc")
