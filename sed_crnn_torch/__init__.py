"""sed_crnn_torch: the SED CRNN framework ported to PyTorch and CUDA.

The counterpart of `sed_crnn_tpu`, module for module (`core/`, `ops/`,
`nn/`, `models/`, `data/`, `parallel/`, `apps/`), with hand-written Hopper kernels in
`ops/kernels/` built from `csrc/`. Importing the package builds nothing and
needs neither a GPU nor the CUDA toolkit.
"""

from sed_crnn_torch.core.config import (
    ExperimentConfig,
    FrontendConfig,
    ModelConfig,
    TrainConfig,
    get_preset,
)

__all__ = ["ExperimentConfig", "FrontendConfig", "ModelConfig", "TrainConfig", "get_preset"]
