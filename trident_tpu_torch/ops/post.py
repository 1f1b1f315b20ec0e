"""Post-processing: supersample resolve + bloom.

Port of trident_tpu/ops/post.py, plain PyTorch (the JAX package has no
kernel here). Supersampling is ordered-grid: render at k× and box-resolve.
Bloom runs on the linear HDR image before tonemapping: threshold,
separable Gaussian at quarter resolution, upsample, add. The blur is a
sum of 13 shifted, zero-padded slices per axis, taken in tap order, so it
computes the same on the CPU and on the card (no convolution algorithm
is picked behind the caller's back).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def resolve_supersample(img: Tensor, factor: int) -> Tensor:
    """(H·f, W·f, C) → (H, W, C) box filter."""
    if factor <= 1:
        return img
    h, w, c = img.shape
    return img.reshape(h // factor, factor, w // factor, factor,
                       c).mean(dim=(1, 3))


def _gaussian_kernel1d(radius: int, sigma: float, device) -> Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def _blur_axis(img: Tensor, k: Tensor, radius: int, axis: int) -> Tensor:
    """Correlate (H, W, C) with the symmetric 1-D kernel `k` along `axis`
    (0 = rows, 1 = columns), zero padding."""
    n = img.shape[axis]
    # F.pad lists (before, after) pairs from the last dim: C, then W, then H
    pad = (0, 0, radius, radius) if axis == 1 else (0, 0, 0, 0, radius, radius)
    padded = F.pad(img, pad)
    out = None
    for j in range(2 * radius + 1):
        term = padded.narrow(axis, j, n) * k[j]
        out = term if out is None else out + term
    return out


def _blur_separable(img: Tensor, radius: int, sigma: float) -> Tensor:
    """Gaussian blur (H, W, C): horizontal, then vertical."""
    k = _gaussian_kernel1d(radius, sigma, img.device)
    return _blur_axis(_blur_axis(img, k, radius, 1), k, radius, 0)


def bloom(hdr: Tensor, threshold: float = 1.0, strength: float = 0.6,
          radius: int = 6, sigma: float = 3.0) -> Tensor:
    """Add blurred highlights to a linear HDR image (H, W, 3)."""
    h, w, _ = hdr.shape
    bright = torch.clamp_min(hdr - threshold, 0.0)
    # quarter-res blur for a wide, cheap kernel
    h4, w4 = h // 4 * 4, w // 4 * 4
    small = bright[:h4, :w4].reshape(h4 // 4, 4, w4 // 4, 4, 3).mean(dim=(1, 3))
    blurred = _blur_separable(small, radius, sigma)
    up = blurred.repeat_interleave(4, dim=0).repeat_interleave(4, dim=1)
    if h != h4 or w != w4:
        up = F.pad(up.permute(2, 0, 1)[None], (0, w - w4, 0, h - h4),
                   mode="replicate")[0].permute(1, 2, 0)
    return hdr + strength * up
