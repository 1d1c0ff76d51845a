"""Checkpoint migration: reference-lineage weights <-> parameter trees.

Counterpart of the JAX package's `models/transplant.py`, with its mapping,
its module discovery and its error messages. Its trees are numpy: every
import returns, and every export takes, ``(params, state)`` trees of
float32 arrays in the JAX checkpoint layout, the layout `core/checkpoint.py`
stores and `models/convert.py` (`from_jax`, `load_model`) carries into the
port's `CRNN`. So an imported model serves, evaluates and fine-tunes here,
and the JAX package reads the same npz.

Import — two paths cover the reference's two generations:

* **Torch/Lightning** (reference `sed.py:82-112`, `crnn_lightning.py:41-73`):
  ``load_torch_checkpoint`` maps a torch ``state_dict`` onto the
  timepooled-v1/v2 presets (torch GRUs carry cuDNN ``reset_after`` gate
  semantics, so they cannot land on the keras-convention sednet cell).
* **Keras** (the original SEDnet lineage, keras 2.2.4):
  ``load_keras_checkpoint`` reads either a legacy keras-2 HDF5 weight file
  (the format the 2017-era ``ModelCheckpoint`` wrote) with ``h5py`` alone,
  or a model file the installed keras can load (``.keras``/full-model
  ``.h5``), and maps it onto the sednet presets — gate columns reordered
  z,r,h -> r,z,n, conv kernels already HWIO.

``h5py`` and ``keras`` are imported only by the functions that need them;
keras only for files that are not legacy HDF5.

Torch layout conventions converted:

* Conv2d ``(out, in, kh, kw)`` -> HWIO ``(kh, kw, in, out)``;
* Linear/GRU weights transpose to right-multiply form (``x @ w``);
* torch's stacked bidirectional ``nn.GRU(num_layers=k)`` splits into k
  successive BiGRU parameter dicts (gate order r,z,n and reset_after=True
  match torch/cuDNN — see `nn/gru.py`);
* BatchNorm running stats land in model STATE, affine in params.

Modules are discovered structurally (4-D conv kernels, ``running_mean`` for
BN, ``weight_ih_l0`` for GRUs, trailing 2-D weights for the head) in
state-dict insertion order — torch preserves registration order, so this
matches the sequential architectures used here without hard-coding names.

Export — the reverse migration, so models trained here deploy in the
reference stacks unchanged: ``save_torch_checkpoint`` writes a torch
``state_dict`` whose keys load strictly into the reference's own model
classes (`sed.py:82-112` v1 naming, `crnn_lightning.py:41-73` v2 naming, or
a generic naming that round-trips through ``load_torch_checkpoint``), and
``save_keras_checkpoint`` writes the sednet lineage either as a legacy
keras-2.2 HDF5 weight file (what 2017-era ``model.load_weights`` consumes)
or as a modern ``.keras`` model. The files are the JAX package's, key for
key and in the same order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

from sed_crnn_torch.core.config import ModelConfig


def _np(v) -> np.ndarray:
    """Accept torch tensors or arrays."""
    if hasattr(v, "detach"):
        v = v.detach()
    if hasattr(v, "cpu"):
        v = v.cpu()
    if hasattr(v, "numpy"):
        v = v.numpy()
    return np.asarray(v)


def _f32(a) -> np.ndarray:
    """A float32, C-contiguous copy that shares no memory with its source
    (what ``jnp.asarray`` gives the JAX package's trees)."""
    return np.array(a, dtype=np.float32, order="C")


def strip_prefixes(sd: Mapping[str, Any], prefixes=("model.", "module.")) -> Dict[str, Any]:
    """Remove a common leading prefix (Lightning's ``model.``, DDP's
    ``module.``) when EVERY key carries it."""
    out = dict(sd)
    for p in prefixes:
        if out and all(k.startswith(p) for k in out):
            out = {k[len(p):]: v for k, v in out.items()}
    return out


def _group_modules(sd: Mapping[str, Any]) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """Group flat state-dict keys by module prefix, insertion-ordered."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        prefix, _, leaf = k.rpartition(".")
        groups.setdefault(prefix, {})[leaf] = _np(v)
    return list(groups.items())


def _gru_layer_params(mod: Dict[str, np.ndarray], layer: int, reverse: bool):
    sfx = f"_l{layer}" + ("_reverse" if reverse else "")
    return {
        "wi": _f32(mod[f"weight_ih{sfx}"].T),
        "wh": _f32(mod[f"weight_hh{sfx}"].T),
        "bi": _f32(mod[f"bias_ih{sfx}"]),
        "bh": _f32(mod[f"bias_hh{sfx}"]),
    }


def params_from_torch_state_dict(
    cfg: ModelConfig, state_dict: Mapping[str, Any]
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Torch ``state_dict`` -> ``(params, state)`` numpy trees for
    `models/convert.py::from_jax`.

    Raises ValueError with the offending shapes when the checkpoint does not
    structurally match ``cfg`` (conv channels, GRU widths, head dims).
    """
    if cfg.name == "sednet":
        raise ValueError(
            "sednet presets use the keras-2.2.4 GRU cell (reset_after=False, "
            "hard_sigmoid gates, single bias) — torch GRU weights encode "
            "cuDNN reset_after semantics and cannot be transplanted onto it; "
            "only the timepooled-v1/v2 presets accept torch checkpoints. "
            "SEDnet checkpoints from the keras lineage import via "
            "load_keras_checkpoint"
        )
    sd = strip_prefixes(state_dict)
    convs: List[Dict[str, np.ndarray]] = []
    bns: List[Dict[str, np.ndarray]] = []
    gru_layers: List[Dict[str, Any]] = []
    linears: List[Dict[str, np.ndarray]] = []

    for name, mod in _group_modules(sd):
        if "running_mean" in mod:
            bns.append(mod)
        elif any(k.startswith("weight_ih_l") for k in mod):
            n_layers = 1 + max(
                int(k.split("_l")[-1].split("_")[0])
                for k in mod
                if k.startswith("weight_ih_l")
            )
            if not any(k.endswith("_reverse") for k in mod):
                raise ValueError(
                    f"GRU module {name!r} is unidirectional; the CRNN family "
                    "uses bidirectional recurrences"
                )
            for layer in range(n_layers):
                gru_layers.append(
                    {
                        "fwd": _gru_layer_params(mod, layer, False),
                        "bwd": _gru_layer_params(mod, layer, True),
                    }
                )
        elif "weight" in mod and mod["weight"].ndim == 4:
            convs.append(mod)
        elif "weight" in mod and mod["weight"].ndim == 2:
            linears.append(mod)
        # anything else (dropout etc.) holds no parameters

    n_blocks = len(cfg.conv_channels)
    if len(convs) != n_blocks or len(bns) != n_blocks:
        raise ValueError(
            f"expected {n_blocks} conv+BN blocks for preset {cfg.name!r}, "
            f"found {len(convs)} convs / {len(bns)} BNs in the checkpoint"
        )
    if len(gru_layers) != len(cfg.gru_hidden):
        raise ValueError(
            f"expected {len(cfg.gru_hidden)} bidirectional GRU layers, "
            f"found {len(gru_layers)}"
        )
    if len(linears) != len(cfg.head_dims):
        raise ValueError(
            f"expected {len(cfg.head_dims)} head dense layers, found {len(linears)}"
        )

    params: Dict[str, Any] = {"conv": [], "bn": [], "gru": gru_layers, "head": []}
    state: Dict[str, Any] = {"bn": []}
    expect_in = cfg.in_channels
    for i, (conv, bn) in enumerate(zip(convs, bns)):
        w = conv["weight"]
        out_ch = cfg.conv_channels[i]
        if w.shape[0] != out_ch or w.shape[1] != expect_in:
            raise ValueError(
                f"conv block {i}: checkpoint kernel {w.shape} vs config "
                f"(out={out_ch}, in={expect_in})"
            )
        params["conv"].append(
            {"w": _f32(w.transpose(2, 3, 1, 0)), "b": _f32(conv["bias"])}
        )
        params["bn"].append({"scale": _f32(bn["weight"]), "bias": _f32(bn["bias"])})
        state["bn"].append(
            {"mean": _f32(bn["running_mean"]), "var": _f32(bn["running_var"])}
        )
        expect_in = out_ch

    for i, (g, h) in enumerate(zip(gru_layers, cfg.gru_hidden)):
        if g["fwd"]["wh"].shape[0] != h:
            raise ValueError(
                f"GRU layer {i}: checkpoint hidden {g['fwd']['wh'].shape[0]} "
                f"vs config {h}"
            )

    for i, (lin, d) in enumerate(zip(linears, cfg.head_dims)):
        if lin["weight"].shape[0] != d:
            raise ValueError(
                f"head layer {i}: checkpoint out-dim {lin['weight'].shape[0]} "
                f"vs config {d}"
            )
        params["head"].append({"w": _f32(lin["weight"].T), "b": _f32(lin["bias"])})

    return params, state


def load_torch_checkpoint(path: str, cfg: ModelConfig):
    """Read a torch/Lightning ``.pt``/``.ckpt`` file and return
    ``(params, state)``. Accepts a raw state_dict or a dict wrapping one
    under ``state_dict``/``model``."""
    import pickle
    import warnings

    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # Lightning checkpoints pickle hyper_parameters as an AttributeDict,
        # which the weights-only unpickler rejects. Only THAT rejection falls
        # back to a full unpickle (arbitrary code execution for a malicious
        # file — hence the warning); corrupt files and IO errors propagate.
        warnings.warn(
            f"{path}: weights-only load rejected the pickle; falling back to "
            "a FULL unpickle, which executes code embedded in the checkpoint "
            "— only do this with checkpoints you trust",
            stacklevel=2,
        )
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    elif isinstance(obj, dict) and isinstance(obj.get("model"), dict) and all(
        hasattr(v, "shape") for v in obj["model"].values()
    ):
        obj = obj["model"]
    return params_from_torch_state_dict(cfg, obj)


# ---------------------------------------------------------------------------
# Keras import (the SEDnet lineage: keras 2.2.4 HDF5 checkpoints)
# ---------------------------------------------------------------------------

# A parsed keras module stream: ("conv", [kernel, bias]),
# ("bn", [gamma, beta, moving_mean, moving_var]),
# ("bigru", {"fwd": [kernel, recurrent, bias], "bwd": [...]}),
# ("dense", [kernel, bias]) — in model order. Parameterless layers
# (activation, pooling, reshape, dropout) are never emitted.
KerasModule = Tuple[str, Any]


def _reorder_keras_gates(w: np.ndarray, hidden: int) -> np.ndarray:
    """Keras packs GRU gate columns as (z, r, h) (update, reset, candidate);
    the port's `nn/gru.py` uses torch's (r, z, n) order. Pure column
    permutation — the cell math is otherwise identical for
    ``reset_after=False`` (keras-2.2 convention)."""
    z, r, h = (
        w[..., :hidden],
        w[..., hidden : 2 * hidden],
        w[..., 2 * hidden :],
    )
    return np.concatenate([r, z, h], axis=-1)


def _keras_gru_dir_params(arrays, hidden: int) -> Dict[str, Any]:
    kernel, recurrent, bias = (np.asarray(a) for a in arrays)
    if recurrent.shape[0] != hidden:
        raise ValueError(
            f"GRU recurrent kernel hidden {recurrent.shape[0]} != config {hidden}"
        )
    if bias.ndim != 1:
        raise ValueError(
            "keras GRU bias has shape "
            f"{bias.shape}: reset_after=True checkpoints carry a (2, 3H) "
            "bias and belong to the modern keras cell — the sednet presets "
            "use the keras-2.2 reset_after=False convention"
        )
    return {
        "wi": _f32(_reorder_keras_gates(kernel, hidden)),
        "wh": _f32(_reorder_keras_gates(recurrent, hidden)),
        "bi": _f32(_reorder_keras_gates(bias, hidden)),
    }


def params_from_keras_modules(
    cfg: ModelConfig, modules: List[KerasModule]
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Ordered keras module stream -> ``(params, state)`` numpy trees. Keras
    conv kernels are already HWIO and dense kernels already right-multiply,
    so only the GRU gate order converts."""
    if cfg.name != "sednet":
        raise ValueError(
            "keras import targets the sednet presets (keras-convention GRU, "
            "reset_after=False); torch-trained timepooled checkpoints go "
            "through load_torch_checkpoint"
        )
    if cfg.gru_gate_activation != "hard_sigmoid":
        import warnings

        warnings.warn(
            "importing a keras SEDnet checkpoint onto a config with "
            f"gru_gate_activation={cfg.gru_gate_activation!r}: keras-2.2.4 "
            "trained its GRU gates with hard_sigmoid — serve with "
            "gru_gate_activation='hard_sigmoid' to reproduce the trained "
            "model's numerics",
            stacklevel=2,
        )
    convs = [m for k, m in modules if k == "conv"]
    bns = [m for k, m in modules if k == "bn"]
    bigrus = [m for k, m in modules if k == "bigru"]
    denses = [m for k, m in modules if k == "dense"]

    n_blocks = len(cfg.conv_channels)
    if len(convs) != n_blocks or len(bns) != n_blocks:
        raise ValueError(
            f"expected {n_blocks} conv+BN blocks for preset {cfg.name!r}, "
            f"found {len(convs)} convs / {len(bns)} BNs"
        )
    if len(bigrus) != len(cfg.gru_hidden):
        raise ValueError(
            f"expected {len(cfg.gru_hidden)} bidirectional GRU layers, "
            f"found {len(bigrus)}"
        )
    if len(denses) != len(cfg.head_dims):
        raise ValueError(
            f"expected {len(cfg.head_dims)} head dense layers, found {len(denses)}"
        )

    params: Dict[str, Any] = {"conv": [], "bn": [], "gru": [], "head": []}
    state: Dict[str, Any] = {"bn": []}
    expect_in = cfg.in_channels
    for i, (conv, bn) in enumerate(zip(convs, bns)):
        w = np.asarray(conv[0])
        out_ch = cfg.conv_channels[i]
        if w.shape[3] != out_ch or w.shape[2] != expect_in:
            raise ValueError(
                f"conv block {i}: checkpoint kernel {w.shape} (HWIO) vs "
                f"config (in={expect_in}, out={out_ch})"
            )
        params["conv"].append({"w": _f32(w), "b": _f32(conv[1])})
        gamma, beta, mean, var = bn
        params["bn"].append({"scale": _f32(gamma), "bias": _f32(beta)})
        state["bn"].append({"mean": _f32(mean), "var": _f32(var)})
        expect_in = out_ch

    for g, h in zip(bigrus, cfg.gru_hidden):
        params["gru"].append(
            {
                "fwd": _keras_gru_dir_params(g["fwd"], h),
                "bwd": _keras_gru_dir_params(g["bwd"], h),
            }
        )

    for i, (dense, d) in enumerate(zip(denses, cfg.head_dims)):
        k = np.asarray(dense[0])
        if k.shape[1] != d:
            raise ValueError(
                f"head layer {i}: checkpoint out-dim {k.shape[1]} vs config {d}"
            )
        params["head"].append({"w": _f32(k), "b": _f32(dense[1])})
    return params, state


def _classify_weight_group(wnames: List[str], arrays: List[np.ndarray]):
    """One legacy-h5 layer (its weight names + arrays) -> KerasModule(s)."""
    if any("backward" in n for n in wnames):  # Bidirectional RNN
        fwd = [a for n, a in zip(wnames, arrays) if "backward" not in n]
        bwd = [a for n, a in zip(wnames, arrays) if "backward" in n]
        if len(fwd) != 3 or len(bwd) != 3:
            raise ValueError(
                f"bidirectional layer has {len(fwd)} forward / {len(bwd)} "
                "backward weights; expected kernel+recurrent+bias each"
            )
        return [("bigru", {"fwd": fwd, "bwd": bwd})]
    if len(arrays) == 4 and all(a.ndim == 1 for a in arrays):
        return [("bn", arrays)]  # gamma, beta, moving_mean, moving_variance
    if arrays and arrays[0].ndim == 4:
        return [("conv", arrays)]
    if arrays and arrays[0].ndim == 2:
        return [("dense", arrays)]
    raise ValueError(
        f"unrecognized keras layer weights {[a.shape for a in arrays]} "
        f"({wnames})"
    )


def load_keras_h5(path: str, cfg: ModelConfig):
    """Legacy keras-2 HDF5 (``model.save`` / ``save_weights`` /
    ``ModelCheckpoint`` of the 2017-era SEDnet, keras 2.2.4): layer order
    from the ``layer_names`` attr, weights from each layer's
    ``weight_names`` attr. Returns ``(params, state)``; needs ``h5py``, not
    keras."""
    import h5py

    def _s(v):
        return v.decode() if isinstance(v, bytes) else str(v)

    modules: List[KerasModule] = []
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        if "layer_names" not in g.attrs:
            raise ValueError(
                f"{path}: no keras-2 'layer_names' attribute — for keras-3 "
                "files use load_keras_checkpoint, which loads via the "
                "installed keras"
            )
        for lname in [_s(n) for n in g.attrs["layer_names"]]:
            lg = g[lname]
            wnames = [_s(n) for n in lg.attrs.get("weight_names", [])]
            if not wnames:
                continue  # parameterless layer
            arrays = [np.asarray(lg[n]) for n in wnames]
            modules.extend(_classify_weight_group(wnames, arrays))
    return params_from_keras_modules(cfg, modules)


def _modules_from_keras_model(model) -> List[KerasModule]:
    """Walk a live keras model's layers (keras 3 API) in model order."""
    modules: List[KerasModule] = []

    def visit(layer):
        kind = type(layer).__name__
        if kind == "Bidirectional":
            modules.append(
                (
                    "bigru",
                    {
                        "fwd": [np.asarray(w) for w in layer.forward_layer.get_weights()],
                        "bwd": [np.asarray(w) for w in layer.backward_layer.get_weights()],
                    },
                )
            )
        elif kind == "TimeDistributed":
            visit(layer.layer)
        elif kind == "Conv2D":
            modules.append(("conv", [np.asarray(w) for w in layer.get_weights()]))
        elif kind == "BatchNormalization":
            modules.append(("bn", [np.asarray(w) for w in layer.get_weights()]))
        elif kind == "Dense":
            modules.append(("dense", [np.asarray(w) for w in layer.get_weights()]))
        # pooling / activation / reshape / permute / dropout: no parameters

    for layer in model.layers:
        visit(layer)
    return modules


# ---------------------------------------------------------------------------
# Export: parameter trees -> reference-stack weight files
# ---------------------------------------------------------------------------


def _is_keras_cell(params: Dict[str, Any]) -> bool:
    """keras-2.2 convention GRUs (reset_after=False) carry a single bias."""
    return any(
        "bh" not in g[d] for g in params["gru"] for d in ("fwd", "bwd")
    )


def resolve_torch_naming(params: Dict[str, Any], naming: str = "auto") -> str:
    """Pick (or validate) the torch state-dict naming scheme.

    * ``"v1"`` — the reference's `sed.py:82-112` class: ``convs.{i}`` /
      ``bns.{i}`` ModuleLists, ONE stacked bidirectional ``gru``, ``fc``
      head. Requires equal GRU hidden sizes with stacked-compatible input
      dims and a single head layer.
    * ``"v2"`` — `crnn_lightning.py:41-73`: a ``conv_stack`` Sequential
      (conv/BN/ReLU/pool per block), ``gru1``/``gru2``, ``d1``/``d2``.
      Requires exactly 2 GRU layers and 2 head layers.
    * ``"generic"`` — ``convs.{i}`` / ``bns.{i}`` / ``grus.{k}`` /
      ``head.{i}``; always valid, round-trips through
      ``load_torch_checkpoint``.
    """
    hidden = [int(np.shape(g["fwd"]["wh"])[0]) for g in params["gru"]]
    stacked = all(h == hidden[0] for h in hidden) and all(
        int(np.shape(params["gru"][k]["fwd"]["wi"])[0]) == 2 * hidden[0]
        for k in range(1, len(hidden))
    )
    v1_ok = stacked and len(params["head"]) == 1
    v2_ok = len(params["gru"]) == 2 and len(params["head"]) == 2
    if naming == "auto":
        return "v1" if v1_ok else ("v2" if v2_ok else "generic")
    if naming == "v1" and not v1_ok:
        raise ValueError(
            "naming='v1' needs a torch-stackable GRU (equal hidden sizes "
            f"{hidden}, layer k>0 input = 2*hidden) and exactly one head "
            f"layer (got {len(params['head'])})"
        )
    if naming == "v2" and not v2_ok:
        raise ValueError(
            "naming='v2' needs exactly 2 GRU layers and 2 head layers "
            f"(got {len(params['gru'])} / {len(params['head'])})"
        )
    if naming not in ("v1", "v2", "generic"):
        raise ValueError(f"unknown naming {naming!r}")
    return naming


def _torch_gru_dir(g: Dict[str, Any], suffix: str) -> Dict[str, np.ndarray]:
    return {
        f"weight_ih{suffix}": _f32(g["wi"]).T,
        f"weight_hh{suffix}": _f32(g["wh"]).T,
        f"bias_ih{suffix}": _f32(g["bi"]),
        f"bias_hh{suffix}": _f32(g["bh"]),
    }


def torch_state_dict_from_params(
    cfg: ModelConfig,
    params: Dict[str, Any],
    state: Dict[str, Any],
    naming: str = "auto",
) -> Dict[str, np.ndarray]:
    """``(params, state)`` -> torch ``state_dict`` (numpy values; wrap with
    ``save_torch_checkpoint`` to write a ``.pt``). Exact inverse of
    ``params_from_torch_state_dict``: conv HWIO -> OIHW, right-multiply
    weights transpose back, BN running stats rejoin the affine params. The
    keys come in the reference classes' registration order, which
    ``_group_modules`` reads back."""
    if cfg.name == "sednet" or _is_keras_cell(params):
        raise ValueError(
            "sednet presets use the keras-convention GRU cell "
            "(reset_after=False, single bias) which torch's cuDNN-layout "
            "nn.GRU cannot represent — export those with "
            "save_keras_checkpoint instead"
        )
    naming = resolve_torch_naming(params, naming)
    sd: Dict[str, np.ndarray] = {}

    def put_conv(key: str, c: Dict[str, Any]):
        sd[f"{key}.weight"] = _f32(c["w"]).transpose(3, 2, 0, 1)
        sd[f"{key}.bias"] = _f32(c["b"])

    def put_bn(key: str, p: Dict[str, Any], s: Dict[str, Any]):
        sd[f"{key}.weight"] = _f32(p["scale"])
        sd[f"{key}.bias"] = _f32(p["bias"])
        sd[f"{key}.running_mean"] = _f32(s["mean"])
        sd[f"{key}.running_var"] = _f32(s["var"])
        # int64 like torch's own counter, so load_state_dict(strict=True)
        # accepts the file in the reference classes.
        sd[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)

    def put_gru(key: str, g: Dict[str, Any], layer: int):
        sd.update(
            {f"{key}.{k}": v
             for k, v in _torch_gru_dir(g["fwd"], f"_l{layer}").items()}
        )
        sd.update(
            {f"{key}.{k}": v
             for k, v in _torch_gru_dir(g["bwd"], f"_l{layer}_reverse").items()}
        )

    def put_linear(key: str, p: Dict[str, Any]):
        sd[f"{key}.weight"] = _f32(p["w"]).T
        sd[f"{key}.bias"] = _f32(p["b"])

    blocks = zip(params["conv"], params["bn"], state["bn"])
    if naming == "v1":
        for i, (c, bp, bs) in enumerate(blocks):
            put_conv(f"convs.{i}", c)
            put_bn(f"bns.{i}", bp, bs)
        for k, g in enumerate(params["gru"]):
            put_gru("gru", g, k)
        put_linear("fc", params["head"][0])
    elif naming == "v2":
        # conv_stack Sequential indices: [conv, BN, ReLU, pool] per block.
        for i, (c, bp, bs) in enumerate(blocks):
            put_conv(f"conv_stack.{4 * i}", c)
            put_bn(f"conv_stack.{4 * i + 1}", bp, bs)
        put_gru("gru1", params["gru"][0], 0)
        put_gru("gru2", params["gru"][1], 0)
        put_linear("d1", params["head"][0])
        put_linear("d2", params["head"][1])
    else:
        for i, (c, bp, bs) in enumerate(blocks):
            put_conv(f"convs.{i}", c)
            put_bn(f"bns.{i}", bp, bs)
        for k, g in enumerate(params["gru"]):
            put_gru(f"grus.{k}", g, 0)
        for i, p in enumerate(params["head"]):
            put_linear(f"head.{i}", p)
    return sd


def save_torch_checkpoint(
    path: str,
    cfg: ModelConfig,
    params: Dict[str, Any],
    state: Dict[str, Any],
    naming: str = "auto",
) -> str:
    """Write a raw torch ``state_dict`` file — the format the reference's
    trainer saves and loads (`sed.py:196-199`)."""
    import torch

    sd = torch_state_dict_from_params(cfg, params, state, naming)
    # np.array: torch.from_numpy needs a writable buffer; transposed views
    # of read-only checkpoint arrays are not.
    torch.save(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path
    )
    return path


def keras_modules_from_params(
    params: Dict[str, Any], state: Dict[str, Any]
) -> List[KerasModule]:
    """``(params, state)`` -> ordered keras module stream (the inverse of
    ``params_from_keras_modules``; the z/r gate swap is an involution)."""
    if not _is_keras_cell(params):
        raise ValueError(
            "torch-convention GRUs (reset_after=True, two biases) cannot be "
            "written as the keras-2.2 cell — export those with "
            "save_torch_checkpoint instead"
        )
    mods: List[KerasModule] = []
    for c, bp, bs in zip(params["conv"], params["bn"], state["bn"]):
        mods.append(("conv", [_f32(c["w"]), _f32(c["b"])]))
        mods.append(
            ("bn", [_f32(bp["scale"]), _f32(bp["bias"]),
                    _f32(bs["mean"]), _f32(bs["var"])])
        )
    for g in params["gru"]:
        h = int(np.shape(g["fwd"]["wh"])[0])
        mods.append(
            (
                "bigru",
                {
                    d: [
                        _reorder_keras_gates(_f32(g[d]["wi"]), h),
                        _reorder_keras_gates(_f32(g[d]["wh"]), h),
                        _reorder_keras_gates(_f32(g[d]["bi"]), h),
                    ]
                    for d in ("fwd", "bwd")
                },
            )
        )
    for p in params["head"]:
        mods.append(("dense", [_f32(p["w"]), _f32(p["b"])]))
    return mods


def save_keras_h5_weights(
    path: str, params: Dict[str, Any], state: Dict[str, Any]
) -> str:
    """Write a legacy keras-2.2 HDF5 weight file (root ``layer_names``
    attr, per-layer ``weight_names`` attrs) — loadable by the 2017-era
    ``model.load_weights`` onto the reference lineage's ``get_model()``
    (keras 2 matches saved weight-bearing layers to model layers in order),
    and by this module's ``load_keras_h5``. Pure h5py; keras not needed."""
    import h5py

    kind_names = {
        "conv": "conv2d",
        "bn": "batch_normalization",
        "bigru": "bidirectional",
        "dense": "time_distributed",
    }
    weight_names = {
        "conv": ("kernel", "bias"),
        "bn": ("gamma", "beta", "moving_mean", "moving_variance"),
        "dense": ("kernel", "bias"),
    }
    counters: Dict[str, int] = {}
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        layer_names = []
        for kind, arrays in keras_modules_from_params(params, state):
            n = counters.get(kind, 0) + 1
            counters[kind] = n
            lname = f"{kind_names[kind]}_{n}"
            layer_names.append(lname.encode())
            lg = g.create_group(lname)
            wnames = []
            if kind == "bigru":
                for tag, arrs in (
                    ("forward_gru", arrays["fwd"]),
                    ("backward_gru", arrays["bwd"]),
                ):
                    for wn, w in zip(
                        ("kernel", "recurrent_kernel", "bias"), arrs
                    ):
                        name = f"{lname}/{tag}/{wn}:0"
                        lg.create_dataset(name, data=w)
                        wnames.append(name.encode())
            else:
                inner = "dense/" if kind == "dense" else ""
                for wn, w in zip(weight_names[kind], arrays):
                    name = f"{lname}/{inner}{wn}:0"
                    lg.create_dataset(name, data=w)
                    wnames.append(name.encode())
            lg.attrs["weight_names"] = np.array(wnames, dtype="S")
        g.attrs["layer_names"] = np.array(layer_names, dtype="S")
    return path


# The registered name is part of the `.keras` format: the JAX package
# registers the same function under it, so either package loads the other's
# exported files.
_KERAS_PACKAGE = "sed_crnn_tpu"
_HARD_SIGMOID_LEGACY = None


def register_keras_custom_objects():
    """keras-2.2's hard_sigmoid (`clip(0.2x+0.5, 0, 1)`), registered as a
    serializable custom activation — keras-3 renamed ``hard_sigmoid`` to
    ``relu6(x+3)/6``, so the legacy gate must ship as a custom object.
    ``load_keras_checkpoint`` registers it automatically; plain-keras users
    loading an exported ``.keras`` call this once before
    ``keras.saving.load_model``. Returns the activation function."""
    global _HARD_SIGMOID_LEGACY
    if _HARD_SIGMOID_LEGACY is None:
        import keras

        @keras.saving.register_keras_serializable(package=_KERAS_PACKAGE)
        def hard_sigmoid_legacy(x):
            return keras.ops.clip(0.2 * x + 0.5, 0.0, 1.0)

        _HARD_SIGMOID_LEGACY = hard_sigmoid_legacy
    return _HARD_SIGMOID_LEGACY


def build_keras_sednet(cfg: ModelConfig):
    """The SEDnet family as a keras-3 functional model matching
    `models/crnn.py`'s structure (reference `README.md:29-44` + diagram):
    channels_last conv blocks with mel-axis pooling, permute to the
    [T, C, F'] flatten order, bidirectional GRUs (reset_after=False),
    time-distributed linear head."""
    import keras

    if cfg.gru_gate_activation == "hard_sigmoid":
        gate = register_keras_custom_objects()
    else:
        gate = cfg.gru_gate_activation
    T, F = cfg.seq_len_in, cfg.n_mels
    inp = keras.Input((T, F, cfg.in_channels))
    x = inp
    for out_ch, p in zip(cfg.conv_channels, cfg.pool):
        x = keras.layers.Conv2D(out_ch, cfg.kernel_size, padding="same")(x)
        x = keras.layers.BatchNormalization(axis=-1, epsilon=cfg.bn_eps)(x)
        x = keras.layers.Activation("relu")(x)
        x = keras.layers.MaxPooling2D((1, p))(x)
        F //= p
    x = keras.layers.Permute((1, 3, 2))(x)  # (T, F', C) -> (T, C, F')
    x = keras.layers.Reshape((T, cfg.conv_channels[-1] * F))(x)
    for h in cfg.gru_hidden:
        x = keras.layers.Bidirectional(
            keras.layers.GRU(
                h,
                activation="tanh",
                recurrent_activation=gate,
                reset_after=False,
                return_sequences=True,
            ),
            merge_mode="concat",
        )(x)
    for d in cfg.head_dims:
        x = keras.layers.TimeDistributed(keras.layers.Dense(d))(x)
    return keras.Model(inp, x)


def keras_model_from_params(
    cfg: ModelConfig, params: Dict[str, Any], state: Dict[str, Any]
):
    """Build the keras SEDnet and load these weights into it. Returns a live
    keras model whose inference matches `models/crnn.py`."""
    if cfg.name != "sednet":
        raise ValueError(
            "keras export targets the sednet presets (keras-convention GRU); "
            "timepooled checkpoints export with save_torch_checkpoint"
        )
    model = build_keras_sednet(cfg)
    mods = iter(keras_modules_from_params(params, state))

    def take(want: str, layer):
        kind, arrays = next(mods)
        if kind != want:
            raise ValueError(f"layer order mismatch: {kind} at {layer.name}")
        return arrays

    for layer in model.layers:
        kind = type(layer).__name__
        if kind == "Conv2D":
            layer.set_weights(take("conv", layer))
        elif kind == "BatchNormalization":
            layer.set_weights(take("bn", layer))
        elif kind == "Bidirectional":
            arrays = take("bigru", layer)
            layer.forward_layer.set_weights(arrays["fwd"])
            layer.backward_layer.set_weights(arrays["bwd"])
        elif kind == "TimeDistributed":
            layer.layer.set_weights(take("dense", layer))
    leftover = next(mods, None)
    if leftover is not None:
        raise ValueError(f"unconsumed module {leftover[0]!r}")
    return model


def save_keras_checkpoint(
    path: str, cfg: ModelConfig, params: Dict[str, Any], state: Dict[str, Any]
) -> str:
    """Write a keras checkpoint of a sednet-preset model: ``.h5``/``.hdf5``
    -> legacy keras-2.2 weight file (for reference-lineage ``load_weights``,
    no keras needed to write); ``.keras`` -> modern full-model file (with
    ``hard_sigmoid`` gates the file references the registered legacy
    activation — call ``register_keras_custom_objects()`` before a
    plain-keras ``load_model``; ``load_keras_checkpoint`` does so itself)."""
    if cfg.name != "sednet":
        raise ValueError(
            "keras export targets the sednet presets (keras-convention GRU); "
            "timepooled checkpoints export with save_torch_checkpoint"
        )
    if path.endswith((".h5", ".hdf5")):
        return save_keras_h5_weights(path, params, state)
    if path.endswith(".keras"):
        keras_model_from_params(cfg, params, state).save(path)
        return path
    raise ValueError(
        f"unrecognized keras checkpoint extension in {path!r}: use .h5/.hdf5 "
        "(legacy keras-2 weights) or .keras (modern full model)"
    )


def load_keras_checkpoint(path: str, cfg: ModelConfig):
    """Read a keras SEDnet checkpoint and return ``(params, state)``.

    Legacy keras-2 HDF5 files (the reference lineage's format) parse
    directly via h5py, without keras; anything else (``.keras``, keras-3
    full-model ``.h5``) loads through the installed keras and is walked
    layer by layer. Forward parity of the mapping against keras inference
    is pinned by `tests/test_torch_transplant.py` (<= 1e-5)."""
    if path.endswith((".h5", ".hdf5")):
        import h5py

        with h5py.File(path, "r") as f:
            g = f["model_weights"] if "model_weights" in f else f
            legacy = "layer_names" in g.attrs
        if legacy:
            return load_keras_h5(path, cfg)
    import keras

    register_keras_custom_objects()
    model = keras.saving.load_model(path, compile=False)
    return params_from_keras_modules(cfg, _modules_from_keras_model(model))
