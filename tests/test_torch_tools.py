"""The port's tooling (`utils/debug.py`, `utils/tracing.py`,
`core/checkpoint.py::latest_checkpoint`, `train/artifacts.py::log_save`,
`run_fold(debug=True)`, the console scripts) against the JAX package's on
the CPU.

Debug texts, `tree_norms` keys, `check_shape` and `guard_scores` messages,
`StepClock` records, `latest_checkpoint` and `log_save` must be identical
to JAX's; `tree_norms` values agree within 1e-6 relative (float32 sums in
two orders). `run_fold(debug=True)` must leave a run's history bitwise
unchanged, and a planted NaN must raise JAX's `NonFiniteError` text at the
same epoch as JAX's `run_fold(debug=True)`: NaN in every training window
(epoch 1), and a NaN in a checkpoint's head weights resumed at epoch 2
(epoch 3).
"""

import dataclasses
import json
import os
import tomllib
from importlib import import_module
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_crnn_tpu.core import checkpoint as jax_ckpt
from sed_crnn_tpu.train import artifacts as jax_artifacts
from sed_crnn_tpu.train import loop as jax_loop
from sed_crnn_tpu.utils import debug as jax_debug
from sed_crnn_tpu.utils import tracing as jax_tracing

from sed_crnn_torch.apps import train as train_app
from sed_crnn_torch.core import checkpoint as port_ckpt
from sed_crnn_torch.models import get_model
from sed_crnn_torch.models.convert import to_jax
from sed_crnn_torch.parallel import mesh as mesh_mod
from sed_crnn_torch.train import artifacts
from sed_crnn_torch.train import loop
from sed_crnn_torch.utils import debug, tracing
from tests.test_torch_model import narrowed

REPO = Path(__file__).resolve().parents[1]


def _tree(bad: bool):
    """A nested tree of dicts, lists and tuples (keys out of order, a None
    subtree), with non-finite entries in two leaves when ``bad``."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    c = rng.standard_normal((2, 2)).astype(np.float32)
    if bad:
        a[1, 2], b[0], b[4] = np.nan, np.inf, -np.inf
    return {"z": [a, (b, np.float32(2.5))], "a": {"w": c, "none": None}, "b": [np.arange(3)]}


def _as(tree, leaf):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _as(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as(v, leaf) for v in tree)
    return leaf(tree)


def _message(mod, tree, label):
    with pytest.raises(mod.NonFiniteError) as e:
        mod.assert_tree_finite(tree, label)
    return str(e.value)


@pytest.mark.parametrize("leaf", ["numpy", "torch"])
def test_debug_messages_and_norm_keys_are_jax(leaf):
    conv = np.asarray if leaf == "numpy" else torch.as_tensor
    jt = _as(_tree(True), jnp.asarray)
    got = _message(debug, _as(_tree(True), conv), "fold 2 epoch 7 params")
    assert got == _message(jax_debug, jt, "fold 2 epoch 7 params")
    assert "['z'][0]: 1/12 non-finite" in got and "['z'][1][0]: 2/5 non-finite" in got
    debug.assert_tree_finite(_as(_tree(False), conv), "fine")
    norms, want = debug.tree_norms(_as(_tree(False), conv)), jax_debug.tree_norms(
        _as(_tree(False), jnp.asarray))
    assert list(norms) == list(want)
    np.testing.assert_allclose([norms[k] for k in want], list(want.values()), rtol=1e-6)


def test_debug_paths_of_a_model_tree_are_jax():
    """The parameters in the JAX layout (as `run_fold(debug=True)` checks
    them) name a failing leaf by its JAX path."""
    _, tc = narrowed("sednet-dcase")
    model = get_model(tc.model).init_parameters(torch.Generator().manual_seed(2))
    params, _ = to_jax(model.state_dict(), tc.model)
    params["gru"][1]["bwd"]["wh"][0, 0] = np.nan
    params["conv"][2]["b"][:] = np.inf
    got = _message(debug, params, "fold 1 epoch 3 params")
    assert got == _message(jax_debug, _as(params, jnp.asarray), "fold 1 epoch 3 params")
    assert got.splitlines()[1:] == ["  ['conv'][2]['b']: 8/8 non-finite",
                                    "  ['gru'][1]['bwd']['wh']: 1/192 non-finite"]


@pytest.mark.parametrize("shape,expected", [
    ((3, 4), (3, 4)), ((3, 4), (-1, 4)), ((3, 4), (3, 5)), ((3, 4), (3, 4, 1)), ((2,), (-1,)),
])
def test_check_shape_is_jax(shape, expected):
    x = np.zeros(shape)
    outcomes = []
    for mod in (debug, jax_debug):
        try:
            mod.check_shape(torch.zeros(shape) if mod is debug else x, expected, "windows")
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("loss", [0.25, float("nan"), float("inf"), None])
def test_guard_scores_is_jax(loss):
    scores = {} if loss is None else {"loss": loss}
    outcomes = []
    for mod, s in ((debug, {k: torch.tensor(v) for k, v in scores.items()}),
                   (jax_debug, scores)):
        try:
            mod.guard_scores(s, 7, 2)
            outcomes.append(None)
        except mod.NonFiniteError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    if loss is not None and not np.isfinite(loss):
        assert outcomes[0].startswith(f"fold 2 epoch 7: non-finite loss {loss} ")


def test_step_clock_record_is_jax():
    assert tracing.FRAMES_PER_SEC == jax_tracing.FRAMES_PER_SEC
    clocks = [tracing.StepClock(256), jax_tracing.StepClock(256)]
    for c in clocks:
        assert c.record() == {"windows": 0, "elapsed_sec": 0.0, "audio_hours_per_sec": 0.0}
        with c:
            c.add_windows(128)
        assert c.elapsed > 0
        c.add_windows(72)
        c.elapsed = 0.123456789   # the same wall time in both
    assert clocks[0].record() == clocks[1].record()
    assert clocks[0].audio_seconds == clocks[1].audio_seconds == 200 * 256 / (44100 / 1024)
    clocks[0].reset()
    assert (clocks[0].windows, clocks[0].elapsed) == (0, 0.0)


def test_latest_checkpoint_is_jax(tmp_path):
    assert port_ckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    assert port_ckpt.latest_checkpoint(str(tmp_path)) is None
    names = ["best_fold1.npz", "last_fold1.npz", "last_fold2.npz", "notes.txt",
             "epoch002-valer0.500_fold1.npz"]
    for i, n in enumerate(names):
        p = tmp_path / n
        p.write_bytes(b"x")
        os.utime(p, (1_000_000 + 10 * i, 1_000_000 + [30, 10, 20, 99, 5][i]))
    for prefix in ("", "last", "best", "epoch", "none"):
        got = port_ckpt.latest_checkpoint(str(tmp_path), prefix)
        assert got == jax_ckpt.latest_checkpoint(str(tmp_path), prefix)
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "best_fold1.npz")
    assert port_ckpt.latest_checkpoint(str(tmp_path), "last") == str(tmp_path / "last_fold2.npz")


def test_log_save_is_jax(capsys):
    artifacts.log_save("art/best_fold1.npz")
    got = capsys.readouterr().out
    jax_artifacts.log_save("art/best_fold1.npz")
    assert got == capsys.readouterr().out == "saved -> art/best_fold1.npz\n"


def test_profile_trace_writes_the_annotated_names(tmp_path):
    model = torch.nn.Linear(8, 4)
    with tracing.profile_trace(str(tmp_path)):
        with tracing.annotate("frontend"):
            x = torch.randn(16, 8)
        with tracing.annotate("train step"):
            model(x).sum().backward()
    trace = json.loads((tmp_path / tracing.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"frontend", "train step"} <= names
    assert any(n and "addmm" in n for n in names)


def test_profile_trace_survives_a_profiler_that_cannot_start(tmp_path, monkeypatch, capsys):
    def broken(**kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with tracing.profile_trace(str(tmp_path)):
        ran.append(1)
    assert ran == [1] and not (tmp_path / tracing.TRACE_FILE).exists()
    assert "profiler unavailable" in capsys.readouterr().out


def test_annotate_touches_nvtx_only_with_a_card(monkeypatch):
    def refuse(name):
        raise AssertionError("NVTX without a card")

    monkeypatch.setattr(torch.cuda.nvtx, "range", refuse)
    with tracing.annotate("serve"):
        pass
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range", Range)
    with tracing.annotate("serve"):
        pass
    assert entered == ["serve"]


# ---- run_fold(debug=True) ----------------------------------------------------------


def _cfgs(max_epochs=2):
    jc, tc = narrowed("sednet-dcase", seq_len_in=64, dropout=0.0)
    train = dict(batch_size=4, max_epochs=max_epochs, plot_every=0)
    return (jc.replace(train=dataclasses.replace(jc.train, **train)),
            tc.replace(train=dataclasses.replace(tc.train, **train)))


def _fold():
    return train_app.synthetic_folds(1, frames=800, seed=6, n_classes=6)[1]


def _raised(fn, *args, **kw):
    """The NonFiniteError text ``fn`` raises: the port's class, or JAX's for
    JAX's `run_fold`."""
    error = jax_debug.NonFiniteError if fn is jax_loop.run_fold else debug.NonFiniteError
    with pytest.raises(error) as got:
        fn(*args, **kw)
    return str(got.value)


def test_run_fold_debug_changes_nothing_else(tmp_path):
    _, tc = _cfgs()
    fold = _fold()
    plain = loop.run_fold(tc, fold, 1, str(tmp_path / "plain"), verbose=False, device="cpu")
    dbg = loop.run_fold(tc, fold, 1, str(tmp_path / "dbg"), verbose=False, device="cpu",
                        debug=True)
    assert dbg.history == plain.history and dbg.epochs_run == plain.epochs_run == 2
    a, b = (port_ckpt._flatten(port_ckpt.load_checkpoint(str(tmp_path / d / "last_fold1.npz"))[0])
            for d in ("plain", "dbg"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_run_fold_debug_raises_where_jax_does(tmp_path):
    jc, tc = _cfgs()
    # a NaN in every training window: both raise on epoch 1's training loss
    fold = _fold()
    fold["train_x"][:: tc.model.seq_len_in, 5] = np.nan
    got = _raised(loop.run_fold, tc, fold, 1, str(tmp_path / "p"), verbose=False,
                  device="cpu", debug=True)
    want = _raised(jax_loop.run_fold, jc, fold, 1, str(tmp_path / "j"), verbose=False,
                   debug=True)
    assert got == want
    assert got.startswith("fold 1 epoch 1: non-finite loss nan ")
    # without debug the port trains through it, as JAX does
    res = loop.run_fold(tc, fold, 1, str(tmp_path / "q"), verbose=False, device="cpu")
    assert res.epochs_run == 2 and np.isnan(res.history["loss_tr"][0])

    # a NaN in a checkpoint's head weights, resumed after epoch 2: both raise
    # on epoch 3
    fold = _fold()
    loop.run_fold(tc, fold, 1, str(tmp_path / "ck"), verbose=False, device="cpu")
    tree, meta = port_ckpt.load_checkpoint(str(tmp_path / "ck" / "last_fold1.npz"))
    tree["params"]["head"][0]["w"][0, 0] = np.nan
    bad = port_ckpt.save_checkpoint(str(tmp_path / "bad.npz"), tree, meta)
    jc4, tc4 = _cfgs(max_epochs=4)
    got = _raised(loop.run_fold, tc4, fold, 1, str(tmp_path / "p2"), resume_from=bad,
                  verbose=False, device="cpu", debug=True)
    want = _raised(jax_loop.run_fold, jc4, fold, 1, str(tmp_path / "j2"), resume_from=bad,
                   verbose=False, debug=True)
    assert got == want and got.startswith("fold 1 epoch 3: non-finite loss nan ")


def test_run_fold_debug_under_a_data_parallel_trainer(tmp_path):
    _, tc = _cfgs()
    fold = _fold()
    plain = loop.run_fold(tc, fold, 1, str(tmp_path / "plain"), verbose=False, device="cpu")
    mesh = mesh_mod.make_mesh(1, device="cpu")
    try:
        factory = loop.data_parallel_factory(mesh)
        dp = loop.run_fold(tc, fold, 1, str(tmp_path / "dp"), verbose=False, device="cpu",
                           trainer_factory=factory, debug=True)
        assert dp.history == plain.history
        fold["train_x"][:: tc.model.seq_len_in, 5] = np.nan
        got = _raised(loop.run_fold, tc, fold, 1, str(tmp_path / "nan"), verbose=False,
                      device="cpu", trainer_factory=factory, debug=True)
        assert got.startswith("fold 1 epoch 1: non-finite loss nan ")
    finally:
        mesh.close()


# ---- console scripts ---------------------------------------------------------------


def test_console_scripts_resolve_to_the_ports_mains():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    tpu = {k[len("sedtpu-"):]: v for k, v in scripts.items() if k.startswith("sedtpu-")}
    port = {k[len("sedtorch-"):]: v for k, v in scripts.items() if k.startswith("sedtorch-")}
    assert len(tpu) == 9 and port.keys() == tpu.keys()
    for name, target in port.items():
        module, func = target.split(":")
        assert module == tpu[name].split(":")[0].replace("sed_crnn_tpu.", "sed_crnn_torch.")
        assert callable(getattr(import_module(module), func)), target
