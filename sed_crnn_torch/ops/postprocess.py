"""Probability post-processing before event decoding."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def median_smooth(probs, width: int):
    """Per-class running median along the time axis (axis 0), zero-padded
    at the edges (`scipy.signal.medfilt` semantics). ``width`` must be odd;
    ``width <= 1`` is the identity. Accepts (frames,) or (frames, classes);
    numpy in -> numpy out, tensor in -> tensor out."""
    if width <= 1:
        return probs
    if width % 2 == 0:
        raise ValueError(f"median width must be odd, got {width}")
    was_numpy = isinstance(probs, np.ndarray)
    x = torch.as_tensor(probs)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    r = width // 2
    xp = F.pad(x, (0, 0, r, r))
    out = xp.unfold(0, width, 1).median(dim=-1).values
    if squeeze:
        out = out[:, 0]
    return out.numpy() if was_numpy else out
