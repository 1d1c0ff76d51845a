"""Model zoo: `get_model` builds a `CRNN` from a config or preset name."""

from sed_crnn_torch.core.config import ExperimentConfig, ModelConfig, get_preset
from sed_crnn_torch.models.crnn import CRNN, count_params, model_flops_per_example

__all__ = ["CRNN", "get_model", "count_params", "model_flops_per_example"]


def get_model(cfg) -> CRNN:
    """Build a model from a ModelConfig, ExperimentConfig, or preset name."""
    if isinstance(cfg, str):
        cfg = get_preset(cfg)
    if isinstance(cfg, ExperimentConfig):
        cfg = cfg.model
    if not isinstance(cfg, ModelConfig):
        raise TypeError(f"expected ModelConfig/ExperimentConfig/preset name, got {type(cfg)}")
    return CRNN(cfg)
