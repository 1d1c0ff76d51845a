"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside the
fixture). On a machine with one, and without JAX, run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances as in chip_smoke.py: 1e-5 absolute for the GRU recurrence
(float32, same operation order up to reassociation in the small products),
5e-4 in the log domain for the fused log-mel at finite entries, with an
identical -inf pattern.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sed_crnn_torch.core.config import FrontendConfig
from sed_crnn_torch.ops.kernels.fused_logmel import fused_log_mel, fused_log_mel_plain
from sed_crnn_torch.ops.kernels.gru_scan import gru_scan, gru_scan_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,T,H", [(1, 1, 4), (3, 7, 8), (5, 300, 32), (2, 20, 64)])
@pytest.mark.parametrize("reset_after", [False, True])
@pytest.mark.parametrize("gate", ["sigmoid", "hard_sigmoid"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernel_matches_plain(cuda, B, T, H, reset_after, gate, reverse):
    rng = np.random.default_rng(B * 1000 + T)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    xp = t(rng.standard_normal((B, T, 3 * H)))
    wh = t(rng.standard_normal((H, 3 * H)) / np.sqrt(H))
    bh = t(0.1 * rng.standard_normal(3 * H)) if reset_after else None
    h0 = t(0.5 * rng.standard_normal((B, H)))
    launches = gru_scan.launches
    ys, hl = gru_scan(xp, wh, bh, h0, reset_after, gate, reverse)
    torch.cuda.synchronize()
    assert gru_scan.launches == launches + 1
    ys_p, hl_p = gru_scan_plain(xp, wh, bh, h0, reset_after, gate, reverse)
    torch.testing.assert_close(ys, ys_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(hl, hl_p, rtol=0, atol=1e-5)


def test_gru_kernel_refuses_autograd(cuda):
    """The kernel has no backward yet: a graph through it must not be cut silently."""
    wh = torch.zeros(4, 12, device=cuda, requires_grad=True)
    args = (torch.zeros(2, 3, 12, device=cuda), wh, None, torch.zeros(2, 4, device=cuda),
            False, "sigmoid", False)
    with pytest.raises(NotImplementedError):
        gru_scan(*args)
    with torch.no_grad():
        gru_scan(*args)


def test_gru_kernel_rejects_bad_inputs(cuda):
    xp = torch.zeros(2, 3, 12, device=cuda)
    with pytest.raises(TypeError):
        gru_scan(xp.double(), torch.zeros(4, 12, device=cuda, dtype=torch.float64), None,
                 torch.zeros(2, 4, device=cuda, dtype=torch.float64), False, "sigmoid", False)
    with pytest.raises(ValueError):
        gru_scan(xp, torch.zeros(4, 12), None, torch.zeros(2, 4, device=cuda),
                 False, "sigmoid", False)


def _signal(n, sr, seed, silent=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    y = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(n)
    if silent:
        y[silent[0] : silent[1]] = 0.0
    return y.astype(np.float32)


@pytest.mark.parametrize("cfg", [
    FrontendConfig(sample_rate=16000, n_fft=256, hop_length=128, n_mels=16),
    FrontendConfig(),
    FrontendConfig(center=False),
    FrontendConfig(n_mels=128),
])
@pytest.mark.parametrize("log_floor", [None, 1e-10])
def test_logmel_kernel_matches_plain(cuda, cfg, log_floor):
    cfg = dataclasses.replace(cfg, log_floor=log_floor)
    y = torch.from_numpy(_signal(3 * cfg.sample_rate + 777, cfg.sample_rate, 1,
                                 silent=(cfg.sample_rate, 2 * cfg.sample_rate))).to(cuda)
    launches = fused_log_mel.launches
    got = fused_log_mel(y, cfg)
    torch.cuda.synchronize()
    assert fused_log_mel.launches == launches + 1
    want = fused_log_mel_plain(y, cfg)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    if log_floor is None:
        assert not bool(fin.all())
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=5e-4)
