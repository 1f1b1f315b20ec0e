"""Temporal warp fetch: the history's 12 bytes at each pixel's block.

Port of trident_tpu/ops/warp_pallas.py. The TPU kernel fetches from
(12, hpad, wpad) bf16 channel planes with windowed one-hot MXU products,
streaming two 32-row bands per 8×256 pixel block, because Mosaic has no
vector gather. On the card the fetch is one indexed load per pixel
straight from the (h, w, 12) uint8 history (csrc/warp.cu), with no band
limit, so `build_warp_planes` has no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from trident_tpu_torch import _build

Tensor = torch.Tensor

# The TPU kernel's block and band geometry, kept only for band_ok_mask
BR = 8                      # pixel-block rows
BC = 256                    # pixel-block cols
BAND = 32                   # source rows per band; two bands per block


def warp_hpad(h: int) -> int:
    """The TPU kernel's padded plane height for an h-row history (one
    spare band), which band_ok_mask's band clip depends on."""
    return -(-h // BAND) * BAND + BAND


def band_ok_mask(by: Tensor, in_bounds: Tensor, hpad: int) -> Tensor:
    """(H, W) bool: pixels whose source row fits their 8×256 block's
    two-band window [32k, 32k+64), k = the block's least in-bounds row
    // 32, clipped to [0, hpad // 32 − 2].

    This is the TPU kernel's coverage contract, not a limit of the card's
    kernel, which fetches any row. The port keeps the mask only so that
    the validity channel stays bit-identical to the JAX package's default
    (WARP_MXU on): pixels outside the window fall back to validity 0."""
    h, w = by.shape
    hp, wp = -(-h // BR) * BR, -(-w // BC) * BC
    byp = torch.full((hp, wp), hpad, dtype=by.dtype, device=by.device)
    byp[:h, :w] = torch.where(in_bounds, by, hpad)
    blocks = byp.reshape(hp // BR, BR, wp // BC, BC).transpose(1, 2)
    bymin = blocks.reshape(hp // BR, wp // BC, -1).amin(dim=-1)
    k = torch.clamp(torch.div(bymin, BAND, rounding_mode="floor"), 0,
                    hpad // BAND - 2)
    kpix = k.repeat_interleave(BR, dim=0).repeat_interleave(BC, dim=1)
    kpix = kpix[:h, :w]
    return in_bounds & (by >= kpix * BAND) & (by < (kpix + 2) * BAND)


def warp_fetch_ref(hist: Tensor, by: Tensor, bx: Tensor) -> Tensor:
    """Plain PyTorch twin of the warp kernel: hist (h, w, 12) uint8, by/bx
    (H, W) i32 block indices (−1 = skip) → (H, W, 12) f32 byte values,
    0 where by or bx is negative; other indices clamp into the history."""
    h, w = hist.shape[0], hist.shape[1]
    skip = (by < 0) | (bx < 0)
    block = hist[by.clamp(0, h - 1).long(), bx.clamp(0, w - 1).long()]
    return torch.where(skip[..., None], 0.0, block.float())


def warp_fetch(hist: Tensor, by: Tensor, bx: Tensor) -> Tensor:
    """(H, W, 12) f32 history bytes at (by, bx): the CUDA kernel for tensors
    on the card, the plain version for tensors on the CPU."""
    if by.device.type == "cpu":
        return warp_fetch_ref(hist, by, bx)
    if by.device.type != "cuda" or any(a.device != by.device
                                       for a in (hist, bx)):
        raise ValueError("hist, by and bx must be on one CUDA device")
    if (hist.dtype != torch.uint8 or hist.dim() != 3 or hist.shape[2] != 12
            or not hist.is_contiguous() or hist.data_ptr() % 4):
        raise ValueError("hist must be a contiguous, 4-byte aligned "
                         "(h, w, 12) uint8 tensor")
    for a in (by, bx):
        if (a.dtype != torch.int32 or a.dim() != 2 or a.shape != by.shape
                or not a.is_contiguous()):
            raise ValueError("by/bx must be contiguous (H, W) i32 of one shape")
    out = torch.empty((*by.shape, 12), dtype=torch.float32, device=by.device)
    _build.launch("trident_warp",
                  [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p],
                  by.device, hist.data_ptr(), hist.shape[0], hist.shape[1],
                  by.data_ptr(), bx.data_ptr(), by.numel(), out.data_ptr())
    return out
