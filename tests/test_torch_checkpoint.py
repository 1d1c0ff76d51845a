"""Checkpoint interchange: the port's numpy-only npz reader and writer
(sed_crnn_torch/core/checkpoint.py) against the JAX package's. A round trip
JAX save -> port load -> port save -> JAX load must be bit-exact: same
container kinds, keys, dtypes, values and metadata."""

import numpy as np
import pytest
import torch

from sed_crnn_tpu.core import checkpoint as jax_ckpt

from sed_crnn_torch.core import checkpoint as port_ckpt


def _tree(rng):
    return {
        "params": {
            "conv": [{"w": rng.standard_normal((3, 3, 1, 4)).astype(np.float32),
                      "b": rng.standard_normal(4).astype(np.float32)}],
            "gru": [{"fwd": {"wi": rng.standard_normal((5, 6)).astype(np.float32)}}],
        },
        "model_state": {"bn": [{"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}]},
        "rng": np.array([7, 11], np.uint32),
        "pair": (np.float64(1.5), np.arange(3, dtype=np.int64)),
        "half": rng.standard_normal(3).astype(np.float16),
    }


def _assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_round_trip_is_bit_exact(tmp_path, first):
    tree = _tree(np.random.default_rng(0))
    meta = {"epoch": 3, "best": 0.25, "fold": 1}
    writers = {"jax": jax_ckpt.save_checkpoint, "port": port_ckpt.save_checkpoint}
    readers = {"jax": jax_ckpt.load_checkpoint, "port": port_ckpt.load_checkpoint}
    second = "port" if first == "jax" else "jax"

    writers[first](str(tmp_path / "a.npz"), tree, meta)
    t1, m1 = readers[second](str(tmp_path / "a.npz"))
    writers[second](str(tmp_path / "b.npz"), t1, m1)
    t2, m2 = readers[first](str(tmp_path / "b.npz"))
    want, want_meta = jax_ckpt.load_checkpoint(str(tmp_path / "a.npz"))
    _assert_same(t1, want)
    _assert_same(t2, want)
    assert m1 == m2 == want_meta == meta


def test_port_writes_torch_tensors_as_arrays(tmp_path):
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    port_ckpt.save_checkpoint(str(tmp_path / "t.npz"), {"w": w, "l": [w[0]]})
    tree, meta = jax_ckpt.load_checkpoint(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(tree["w"], w.numpy())
    np.testing.assert_array_equal(tree["l"][0], w[0].numpy())
    assert meta == {}


def test_none_leaf_and_bad_key_raise(tmp_path):
    with pytest.raises(ValueError):
        port_ckpt.save_checkpoint(str(tmp_path / "x.npz"), {"a": None})
    with pytest.raises(ValueError):
        port_ckpt.save_checkpoint(str(tmp_path / "x.npz"), {"a/b": np.zeros(1)})
