"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a GPU and without an explicit ``"cpu"`` they raise: the port never
falls back to the CPU quietly.

Precision on the card: float32 matrix products and cuDNN convolutions are
both pinned to full float32 (no TF32) whenever a CUDA device is resolved,
so that the card and the CPU compute the same float32 function.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def set_full_fp32() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        set_full_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev
