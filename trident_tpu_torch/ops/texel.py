"""Bilinear texel fetch: one 2×2 RGBA8 quad per pixel.

Port of trident_tpu/ops/texel_pallas.py. On the TPU the per-pixel gather
became windowed one-hot matrix products against a VMEM-resident bf16
table; on the card it is one 16-byte load per pixel from the (Q, 4) u32
quad table (csrc/texel.cu), with no table-size cap. Two layouts:
(H, W) → (H, W, 4) (sample_bilinear) and the raster's tile layout
(n_tiles, 1024) → (n_tiles, 4, 1024) (sample_bilinear_planar, the tiled
shading path's).
"""

from __future__ import annotations

import ctypes

import torch

from trident_tpu_torch import _build

Tensor = torch.Tensor


def _unpack_rgba8(v: Tensor) -> Tensor:
    """(...,) u32 bits held as i32 → (..., 4) f32 byte values."""
    return torch.stack([((v >> s) & 0xFF).float() for s in (0, 8, 16, 24)],
                       dim=-1)


def sample_bilinear_plain(quads: Tensor, idx: Tensor, fx: Tensor,
                          fy: Tensor) -> Tensor:
    """Plain PyTorch twin of the texel kernel: quads (Q,4) i32, idx (H,W)
    i32 (−1 = uncovered), fx/fy (H,W) f32 → (H,W,4) f32 in [0,1], the
    lerps in shading._bilinear_flat's expression order."""
    q = quads[idx.clamp_min(0).long()]                      # (H,W,4)
    t00, t10 = _unpack_rgba8(q[..., 0]), _unpack_rgba8(q[..., 1])
    t01, t11 = _unpack_rgba8(q[..., 2]), _unpack_rgba8(q[..., 3])
    fx, fy = fx[..., None], fy[..., None]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    out = (top * (1.0 - fy) + bot * fy) * (1.0 / 255.0)
    return torch.where((idx >= 0)[..., None], out, 0.0)


def _check_inputs(quads: Tensor, idx: Tensor, fx: Tensor,
                  fy: Tensor) -> None:
    if idx.device.type != "cuda" or any(
            a.device != idx.device for a in (quads, fx, fy)):
        raise ValueError("quads, idx, fx and fy must be on one CUDA device")
    if (quads.dtype != torch.int32 or quads.dim() != 2 or quads.shape[1] != 4
            or not quads.is_contiguous() or quads.data_ptr() % 16):
        raise ValueError("quads must be a contiguous, 16-byte aligned (Q,4) "
                         "i32 table")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be contiguous i32")
    for a in (fx, fy):
        if (a.dtype != torch.float32 or a.shape != idx.shape
                or not a.is_contiguous()):
            raise ValueError("fx/fy must be contiguous f32 shaped like idx")


def sample_bilinear(quads: Tensor, idx: Tensor, fx: Tensor,
                    fy: Tensor) -> Tensor:
    """(H,W,4) bilinear samples: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    if idx.device.type == "cpu":
        return sample_bilinear_plain(quads, idx, fx, fy)
    _check_inputs(quads, idx, fx, fy)
    out = torch.empty((*idx.shape, 4), dtype=torch.float32, device=idx.device)
    _build.launch("trident_texel",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p],
                  idx.device, idx.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                  quads.data_ptr(), idx.numel(), out.data_ptr())
    return out


def sample_bilinear_planar_plain(quads: Tensor, idx: Tensor, fx: Tensor,
                                 fy: Tensor) -> Tensor:
    """Plain PyTorch twin of the planar texel kernel: (rows, npx) idx/fx/fy
    → (rows, 4, npx), sample_bilinear_plain's values with the channel
    axis moved in front of the pixels."""
    return sample_bilinear_plain(quads, idx, fx, fy).permute(0, 2, 1) \
        .contiguous()


def sample_bilinear_planar(quads: Tensor, idx: Tensor, fx: Tensor,
                           fy: Tensor) -> Tensor:
    """(rows, 4, npx) bilinear samples of (rows, npx) pixel planes (the
    raster's (n_tiles, 1024) tile layout; sample_bilinear_mxu_tiled): the
    CUDA kernel for tensors on the card, the plain version for tensors on
    the CPU."""
    if idx.device.type == "cpu":
        return sample_bilinear_planar_plain(quads, idx, fx, fy)
    _check_inputs(quads, idx, fx, fy)
    if idx.dim() != 2:
        raise ValueError("idx must be a (rows, npx) plane")
    rows, npx = idx.shape
    out = torch.empty((rows, 4, npx), dtype=torch.float32, device=idx.device)
    _build.launch("trident_texel_planar",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p], idx.device,
                  idx.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                  quads.data_ptr(), rows, npx, out.data_ptr())
    return out
