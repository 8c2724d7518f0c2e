"""Zigzag scan as a constant-index gather."""

from __future__ import annotations

import torch

from ec504_imageencoder_tpu_torch.utils.tables import ZIGZAG_GATHER


def zigzag_scan(blocks: torch.Tensor, gather: torch.Tensor = ZIGZAG_GATHER):
    """(..., 8, 8) -> (..., 64) in zigzag order."""
    flat = blocks.reshape(*blocks.shape[:-2], 64)
    return flat[..., gather.to(device=blocks.device, dtype=torch.long)]
