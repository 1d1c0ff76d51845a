"""Streaming long-file inference with carried GRU state.

Counterpart of the JAX package's `models/streaming.py`. A recording's frames
are zero-padded to whole chunks of ``seq_len_in`` frames and the model runs
chunk by chunk; the forward-GRU states carry across chunk boundaries, so
left context persists over arbitrarily long audio. The backward direction
starts from zero in every chunk unless ``carry_backward`` (an
approximation: bidirectional RNNs are not causal).

``stream_logits_lookahead`` emits chunk k after chunk k+1 has arrived: the
model runs once over the [k, k+1] pair with the carried forward state and
reads the next forward carry out of the pair pass at the chunk boundary
(``carry_at``), giving the backward GRU one chunk of real right context.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sed_crnn_torch.models.crnn import CRNN


def pad_to_chunks(mel: torch.Tensor, chunk: int) -> torch.Tensor:
    """Zero-pad frames up to a chunk multiple -> (n_chunks, chunk, F)."""
    n = mel.shape[0]
    n_chunks = -(-n // chunk)
    mel = F.pad(mel, (0, 0, 0, n_chunks * chunk - n))
    return mel.reshape(n_chunks, chunk, mel.shape[1])


@torch.no_grad()
def stream_logits(model: CRNN, mel: torch.Tensor, carry_backward: bool = False) -> torch.Tensor:
    """mel (frames, n_mels*channels) -> logits
    (ceil(frames/seq_len) * seq_len_out, n_classes)."""
    chunks = pad_to_chunks(mel.to(torch.float32), model.cfg.seq_len_in)
    zero = model.zero_carry(1, mel.device)
    carry = zero
    out = [mel.new_zeros((0, model.cfg.n_classes))]
    for xc in chunks:
        logits, carry = model(xc[None], rnn_carry=carry)
        if not carry_backward:
            carry = [{"fwd": c["fwd"], "bwd": z["bwd"]} for c, z in zip(carry, zero)]
        out.append(logits[0])
    return torch.cat(out).reshape(-1, model.cfg.n_classes)


@torch.no_grad()
def stream_logits_lookahead(model: CRNN, mel: torch.Tensor) -> torch.Tensor:
    """Lookahead streaming: emit chunk k after seeing chunk k+1 (see the
    module docstring). mel (frames, n_mels*channels) -> logits
    (ceil(frames/seq_len) * seq_len_out, n_classes)."""
    chunks = pad_to_chunks(mel.to(torch.float32), model.cfg.seq_len_in)
    nxt = torch.cat([chunks[1:], torch.zeros_like(chunks[:1])])
    t_chunk = model.seq_len_out
    zero = model.zero_carry(1, mel.device)
    carry = zero
    out = [mel.new_zeros((0, model.cfg.n_classes))]
    for xc, xn in zip(chunks, nxt):
        logits, mid = model(torch.cat([xc, xn])[None], rnn_carry=carry, carry_at=t_chunk - 1)
        carry = [{"fwd": m["fwd"], "bwd": z["bwd"]} for m, z in zip(mid, zero)]
        out.append(logits[0, :t_chunk])
    return torch.cat(out).reshape(-1, model.cfg.n_classes)


def stream_probabilities(
    model: CRNN,
    mel: torch.Tensor,
    carry_backward: bool = False,
    lookahead: bool = False,
) -> np.ndarray:
    """Sigmoid frame probabilities trimmed to the true length (in model
    output frames, ``frames // (seq_len_in // seq_len_out)``), as numpy."""
    mel = torch.as_tensor(mel)
    if lookahead:
        logits = stream_logits_lookahead(model, mel)
    else:
        logits = stream_logits(model, mel, carry_backward)
    n_out = int(mel.shape[0] // (model.cfg.seq_len_in // model.cfg.seq_len_out))
    return torch.sigmoid(logits)[:n_out].cpu().numpy()
