"""Cross-entropy over the padded vocab with ignore-index masking.

The port of ``repro/train/loss.py``: the logits go to float32, padded
vocabulary entries become -1e30, ``IGNORE`` labels are masked and read as
token 0, and the mean is over at least one token.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig

__all__ = ["lm_loss"]

IGNORE = -1


def lm_loss(logits, labels, cfg: ModelConfig):
    """logits: [B, S, vocab_padded] (any float dtype); labels: [B, S] int
    with IGNORE at masked positions. Returns (mean loss, token count): a
    float32 and an int32 0-d tensor."""
    vp = logits.shape[-1]
    logits = logits.float()
    # mask padded vocab entries out of the softmax
    if cfg.vocab_padded > cfg.vocab_size:
        pad_mask = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad_mask, -1e30, logits)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - ll) * valid
    n = torch.clamp_min(valid.sum(dtype=torch.int32), 1)
    return nll.sum() / n, n
