"""Zigzag scan and inverse scan as constant-index gathers, and the
post-scan hook of the reference's `ops/zigzag.py`."""

from __future__ import annotations

import torch

from ec504_imageencoder_tpu_torch.utils.tables import ZIGZAG_GATHER_T, ZIGZAG_INDEX_T


def zigzag_scan(blocks: torch.Tensor, gather: torch.Tensor = ZIGZAG_GATHER_T):
    """(..., 8, 8) -> (..., 64) in zigzag order."""
    flat = blocks.reshape(*blocks.shape[:-2], 64)
    return flat[..., gather.to(device=blocks.device, dtype=torch.long)]


def zigzag_descan(scanned: torch.Tensor) -> torch.Tensor:
    """(..., 64) zigzag order -> (..., 8, 8)."""
    flat = scanned[..., ZIGZAG_INDEX_T.to(device=scanned.device, dtype=torch.long)]
    return flat.reshape(*scanned.shape[:-1], 8, 8)


def equalize_coefficients(zz):
    """The coefficient post-scan hook: the identity, by specification.  The
    reference C encoder's equalize_coefficients (image_processing.c:385-398)
    copies its input, its +-1 adjustment being commented out."""
    return zz
