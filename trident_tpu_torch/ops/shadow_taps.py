"""Shadow-map taps: the raw bits of the light's depth map at each pixel's
tap indices.

Port of trident_tpu/ops/shadow_pallas.py (`shadow_tap_bits`). The TPU
kernel has no per-pixel gather, so it selects taps with windowed one-hot
MXU products over four bf16 byte planes of the map; on the card a tap is
a direct load from the f32 map viewed as i32 (csrc/shadow_taps.cu). The
contract is the TPU kernel's: (H, W, ntaps) i32 bits, taps ordered
(y0,x0), (y0,x1), (y1,x0), (y1,x1), and 0 for a tap whose index lies
outside the map (the caller's −1 outside the light frustum). The f32
compare and the PCF lerp stay in ops/shadow.py.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from trident_tpu_torch import _build

Tensor = torch.Tensor


def shadow_tap_bits_plain(depth_map: Tensor, y0: Tensor, x0: Tensor,
                          y1: Optional[Tensor] = None,
                          x1: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch twin of the taps kernel: one indexed read per tap."""
    s = depth_map.shape[0]
    bits = depth_map.view(torch.int32)
    pairs = [(y0, x0)] if y1 is None else [(y0, x0), (y0, x1), (y1, x0),
                                           (y1, x1)]
    taps = []
    for y, x in pairs:
        inside = (y >= 0) & (y < s) & (x >= 0) & (x < s)
        got = bits[y.clamp(0, s - 1).long(), x.clamp(0, s - 1).long()]
        taps.append(torch.where(inside, got, 0))
    return torch.stack(taps, dim=-1)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def shadow_tap_bits(depth_map: Tensor, y0: Tensor, x0: Tensor,
                    y1: Optional[Tensor] = None,
                    x1: Optional[Tensor] = None) -> Tensor:
    """(H, W, 1) hard or (H, W, 4) PCF i32 map bits at the (H, W) i32 tap
    indices: the CUDA kernel for tensors on the card, the plain version for
    tensors on the CPU."""
    if depth_map.device.type == "cpu":
        return shadow_tap_bits_plain(depth_map, y0, x0, y1, x1)
    dev = depth_map.device
    _require(dev.type == "cuda", f"unsupported device {dev}")
    _require(depth_map.dtype == torch.float32 and depth_map.dim() == 2
             and depth_map.shape[0] == depth_map.shape[1]
             and depth_map.is_contiguous(),
             "depth_map must be a contiguous (S, S) f32 map")
    pcf = y1 is not None
    idx = (y0, x0, y1, x1) if pcf else (y0, x0)
    for a in idx:
        _require(a is not None and a.dtype == torch.int32 and a.device == dev
                 and a.is_contiguous() and a.shape == y0.shape
                 and a.dim() == 2, "tap indices must be contiguous (H, W) i32 "
                 "on the map's device")
    h, w = y0.shape
    ntaps = 4 if pcf else 1
    out = torch.empty((h, w, ntaps), dtype=torch.int32, device=dev)
    _build.launch("trident_shadow_taps",
                  [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                  + [ctypes.c_int, ctypes.c_void_p], dev,
                  depth_map.data_ptr(), depth_map.shape[0], y0.data_ptr(),
                  x0.data_ptr(), y1.data_ptr() if pcf else None,
                  x1.data_ptr() if pcf else None, h * w, out.data_ptr())
    return out
