"""Typed configuration: the experiment presets of the SED CRNN family.

A copy of the JAX package's `core/config.py` (same fields, defaults and
presets, so one preset name means one architecture in both packages), with
the backend names that pointed at XLA or Pallas renamed for this port:

* ``FrontendConfig.backend``: ``"fft"`` (``torch.fft.rfft``) and
  ``"matmul"`` (windowed DFT as two matrix products) keep their names; the
  JAX ``"pallas"`` fused log-mel kernel becomes ``"kernel"``, the CUDA
  kernel of `ops/kernels/fused_logmel.py`.
* ``ModelConfig.gru_backend``: ``"auto"`` is the only value, and every
  preset's. It means the CUDA recurrence of `ops/kernels/gru_scan.py` for a
  CUDA tensor at any sequence length and its plain step loop for a CPU
  tensor. The JAX ``"xla"`` scan and ``"pallas"`` kernel compute the same
  function, so a JAX config carrying either maps to ``"auto"``.

`TrainConfig` is copied field for field, so that presets compare equal;
`train/loop.py` reads it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

FRONTEND_BACKENDS = ("fft", "matmul", "kernel")
GRU_BACKENDS = ("auto",)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Log-mel frontend parameters."""

    sample_rate: int = 44_100
    n_fft: int = 2048
    hop_length: int = 1024          # 50% overlap
    n_mels: int = 40
    fmin: float = 0.0
    fmax: Optional[float] = None    # None -> sr / 2
    # librosa-0.7 defaults: centered frames with reflect padding, periodic
    # Hann, slaney-normalized HTK=False mel filterbank.
    center: bool = True
    # None keeps the reference's log with no epsilon (log(0) = -inf).
    log_floor: Optional[float] = None
    # "fft" | "matmul" | "kernel" (see the module docstring).
    backend: str = "fft"
    dtype: str = "float32"

    @property
    def fmax_hz(self) -> float:
        return float(self.sample_rate) / 2.0 if self.fmax is None else self.fmax

    @property
    def frames_per_second(self) -> int:
        return int(self.sample_rate / self.hop_length)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """CRNN architecture description covering all three reference models."""

    name: str = "timepooled_v1"
    n_mels: int = 40
    seq_len_in: int = 64
    n_classes: int = 1
    in_channels: int = 1            # 1 mono, 2 binaural, 6 bin-mul
    conv_channels: Sequence[int] = (128, 128, 128)
    kernel_size: Tuple[int, int] = (3, 3)
    # sednet pools the MEL axis (5,2,2); timepooled pools TIME (2,2,2).
    pool: Sequence[int] = (2, 2, 2)
    pool_axis: str = "time"         # "time" | "mel"
    dropout: float = 0.5
    dropout_per_block: bool = True  # v1: after every block; v2: trailing only
    gru_hidden: Sequence[int] = (32, 32)
    # r/z gate nonlinearity: "sigmoid" or keras-2.2 "hard_sigmoid"
    # (clip(0.2x + 0.5, 0, 1)).
    gru_gate_activation: str = "sigmoid"
    # "auto" only (see the module docstring).
    gru_backend: str = "auto"
    head_dims: Sequence[int] = (1,)
    head_activation: str = "none"   # activation between head layers
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1
    init_scheme: str = "torch"
    dtype: str = "float32"          # parameter dtype
    compute_dtype: str = "float32"  # conv-trunk activation dtype
    remat_trunk: bool = False

    @property
    def seq_len_out(self) -> int:
        if self.pool_axis == "time":
            return self.seq_len_in // math.prod(self.pool)
        return self.seq_len_in

    @property
    def mel_out(self) -> int:
        if self.pool_axis == "mel":
            m = self.n_mels
            for p in self.pool:
                m //= p
            return m
        return self.n_mels


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization / loop parameters (read by `train/loop.py`)."""

    batch_size: int = 128
    max_epochs: int = 200
    early_stop_patience: int = 40
    early_stop_strict_greater: bool = True
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    loss: str = "bce"               # "bce" | "focal"
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    plateau_factor: Optional[float] = None
    plateau_patience: int = 10
    threshold: float = 0.5
    frames_in_1_sec: int = 5
    seed: int = 42
    checkpoint_policy: str = "best"  # "best" | "all"
    k_folds: int = 4
    spec_augment: bool = False
    plot_every: int = 1
    sampler: str = "balanced"       # "balanced" | "sequence"
    val_full_sweep: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    frontend: FrontendConfig
    model: ModelConfig
    train: TrainConfig

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _timepooled_v1() -> ExperimentConfig:
    return ExperimentConfig(
        name="timepooled-v1",
        frontend=FrontendConfig(),
        model=ModelConfig(
            name="timepooled_v1",
            conv_channels=(128, 128, 128),
            pool=(2, 2, 2),
            pool_axis="time",
            dropout=0.5,
            dropout_per_block=True,
            gru_hidden=(32, 32),
            head_dims=(1,),
        ),
        train=TrainConfig(
            loss="bce",
            early_stop_patience=40,
            early_stop_strict_greater=True,
            weight_decay=0.0,
            grad_clip_norm=None,
            frames_in_1_sec=5,
            checkpoint_policy="best",
        ),
    )


def _timepooled_v2() -> ExperimentConfig:
    return ExperimentConfig(
        name="timepooled-v2",
        frontend=FrontendConfig(),
        model=ModelConfig(
            name="timepooled_v2",
            conv_channels=(16, 16, 16),
            pool=(2, 2, 2),
            pool_axis="time",
            dropout=0.4,
            dropout_per_block=False,
            gru_hidden=(16, 8),
            head_dims=(8, 1),
            head_activation="relu",
            compute_dtype="bfloat16",
        ),
        train=TrainConfig(
            loss="focal",
            early_stop_patience=20,
            early_stop_strict_greater=False,
            weight_decay=1e-4,
            grad_clip_norm=1.0,
            plateau_factor=0.5,
            plateau_patience=10,
            frames_in_1_sec=5,
            checkpoint_policy="all",
            spec_augment=True,
        ),
    )


def _sednet_dcase(
    in_channels: int = 1, n_classes: int = 6, gate_activation: str = "sigmoid"
) -> ExperimentConfig:
    return ExperimentConfig(
        name="sednet-dcase",
        frontend=FrontendConfig(),
        model=ModelConfig(
            name="sednet",
            seq_len_in=256,
            n_classes=n_classes,
            in_channels=in_channels,
            conv_channels=(128, 128, 128),
            pool=(5, 2, 2),
            pool_axis="mel",
            dropout=0.5,
            dropout_per_block=True,
            gru_hidden=(32, 32),
            gru_gate_activation=gate_activation,
            head_dims=(16, n_classes),
            head_activation="none",
            init_scheme="keras",
        ),
        train=TrainConfig(
            loss="bce",
            early_stop_patience=100,
            batch_size=128,
            frames_in_1_sec=43,
            checkpoint_policy="best",
            sampler="sequence",
        ),
    )


PRESETS = {
    "timepooled-v1": _timepooled_v1,
    "timepooled-v2": _timepooled_v2,
    "sednet-dcase": _sednet_dcase,
    "sednet-dcase-binaural": lambda: _sednet_dcase(in_channels=2),
    "sednet-dcase-binmul": lambda: _sednet_dcase(in_channels=6),
    # keras-2.2.4 cell numerics: hard_sigmoid recurrent gates.
    "sednet-dcase-keras": lambda: _sednet_dcase(gate_activation="hard_sigmoid"),
}


def get_preset(name: str, **overrides) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    return cfg.replace(**overrides) if overrides else cfg
