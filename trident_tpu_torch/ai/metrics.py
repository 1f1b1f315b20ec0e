"""Quality metrics of the interpolation net: PSNR and Gaussian-window SSIM.

Port of trident_tpu/ai/metrics.py, with its definitions (the reference
trainer's, Scripts/train_frame_generator.py:231-269): PSNR over each
image's MSE with a 1e-8 epsilon, averaged over the batch; SSIM with an
11×11 σ = 1.5 depthwise Gaussian window (VALID), C1 = 0.01², C2 = 0.03².
Images are (B, C, H, W) in [0, 1], the net's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def psnr(prediction: Tensor, target: Tensor) -> Tensor:
    """Mean PSNR over the batch, in dB."""
    mse = torch.mean((prediction - target) ** 2, dim=(1, 2, 3))
    return torch.mean(10.0 * torch.log10(1.0 / (mse + 1e-8)))


def _gaussian_kernel(window: int, sigma: float, device) -> Tensor:
    ax = torch.arange(window, dtype=torch.float32, device=device) \
        - window // 2
    k1 = torch.exp(-(ax ** 2) / (2 * sigma ** 2))
    k1 = k1 / torch.sum(k1)
    return torch.outer(k1, k1)


def _depthwise_filter(img: Tensor, kernel2d: Tensor) -> Tensor:
    """Each channel of (B, C, H, W) filtered by `kernel2d`, VALID: one
    grouped conv."""
    c = img.shape[1]
    k = kernel2d[None, None].expand(c, 1, *kernel2d.shape)
    return F.conv2d(img, k, groups=c)


def ssim(prediction: Tensor, target: Tensor, window: int = 11,
         sigma: float = 1.5) -> Tensor:
    """Mean SSIM over the batch."""
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    kernel = _gaussian_kernel(window, sigma, prediction.device)

    mu_p = _depthwise_filter(prediction, kernel)
    mu_t = _depthwise_filter(target, kernel)
    mu_p2, mu_t2, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t

    sigma_p = _depthwise_filter(prediction * prediction, kernel) - mu_p2
    sigma_t = _depthwise_filter(target * target, kernel) - mu_t2
    sigma_pt = _depthwise_filter(prediction * target, kernel) - mu_pt

    num = (2 * mu_pt + c1) * (2 * sigma_pt + c2)
    den = (mu_p2 + mu_t2 + c1) * (sigma_p + sigma_t + c2)
    return torch.mean(num / den)
