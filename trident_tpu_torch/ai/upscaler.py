"""Neural 2× super-resolution: render at half resolution, reconstruct full.

Port of trident_tpu/ai/upscaler.py, its V2 path (the JAX renderer's
default): the net returns OUTPUT BLOCKS (h, w, 12), a learned residual
over a bilinear base computed directly in block layout, channel
(dy·2+dx)·3+c = output pixel (2y+dy, 2x+dx). Those blocks, quantized to
uint8, are the next frame's temporal history; the display frame is one
depth-to-space of them. The temporal input is the previous history
reprojected into the current view (`warp_from_blocks`), fetched by the
warp kernel (ops/warp.py, csrc/warp.cu).

Public functions keep the JAX package's channels-last layout; the net
converts to NCHW for its four `F.conv2d` calls (the JAX package leaves
these convs to `flax.linen.Conv`, outside any Pallas kernel). The convs
run in f32 with TF32 pinned off (package __init__); the JAX package's
bf16 conv variant (UPSCALE_DTYPE) is not ported.

Weights: `load_upscaler` reads the numpy export of the shipped checkpoint
(assets/upscaler_2x.npz, written by scripts/export_upscaler_npz.py); the
arrays keep their flax names and layouts, and `params_from_flax` maps
them onto the module. The V1 path (`apply_upscaler`, `warp_previous`,
full-resolution history) and training are not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trident_tpu_torch import resolve_device
from trident_tpu_torch.ops.warp import band_ok_mask, warp_fetch, warp_hpad

Tensor = torch.Tensor

DEFAULT_WEIGHTS = Path(__file__).resolve().parents[1] / "assets" / \
    "upscaler_2x.npz"

TEMPORAL_CHANNELS = 16   # 3 current + 12 warped blocks + 1 validity
WARP_CHANNELS = 13       # warp output width


def _axis_phases(v: Tensor, axis: int):
    """Quarter-pixel-shifted pair along `axis` (edge-clamped): the two 2×
    bilinear-upsample phases 0.75·v[i] + 0.25·v[i∓1]."""
    n = v.shape[axis]
    lo = torch.cat([v.narrow(axis, 0, 1), v.narrow(axis, 0, n - 1)], dim=axis)
    hi = torch.cat([v.narrow(axis, 1, n - 1), v.narrow(axis, n - 1, 1)],
                   dim=axis)
    return 0.75 * v + 0.25 * lo, 0.75 * v + 0.25 * hi


def base_blocks(rgb: Tensor) -> Tensor:
    """(…, h, w, 3) → (…, h, w, 12): the 2× bilinear base in block layout,
    phases in the order [y0x0, y0x1, y1x0, y1x1]."""
    y0, y1 = _axis_phases(rgb, axis=rgb.dim() - 3)
    phases = []
    for vy in (y0, y1):
        phases += list(_axis_phases(vy, axis=rgb.dim() - 2))
    return torch.cat(phases, dim=-1)


def depth_to_space(blocks: Tensor) -> Tensor:
    """(…, h, w, 12) → (…, 2h, 2w, 3): an exact relayout of the blocks."""
    *lead, h, w, _ = blocks.shape
    x = blocks.reshape(*lead, h, w, 2, 2, 3)
    n = len(lead)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, 2 * h, 2 * w, 3)


def blocks_to_u8(blocks: Tensor) -> Tensor:
    """Quantize output blocks for the history as pack_rgba8 quantizes the
    display frame: round(x·255), half to even."""
    return torch.round(blocks * 255.0).to(torch.uint8)


class UpscalerNet(nn.Module):
    """(h, w, C) in [0,1] → (h, w, 12) output blocks: four 3×3 convs
    (padding 1) with ReLUs, a residual around the second, and a 12-channel
    head over the block-layout bilinear base, clipped to [0, 1]. Input
    layouts (rgb first; the base comes from those 3): 3 rgb, 4 rgb+depth,
    16 rgb+temporal13, 17 rgb+depth+temporal13."""

    def __init__(self, in_channels: int = TEMPORAL_CHANNELS,
                 base_channels: int = 32) -> None:
        super().__init__()
        c = base_channels
        self.in_channels, self.base_channels = in_channels, base_channels
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels, c, 3, padding=1),
            nn.Conv2d(c, c, 3, padding=1),
            nn.Conv2d(c, c, 3, padding=1),
            nn.Conv2d(c, 12, 3, padding=1),
        ])
        # the detail head starts at zero: an untrained net is the bilinear
        # base, as in the JAX package
        nn.init.zeros_(self.convs[3].weight)
        nn.init.zeros_(self.convs[3].bias)

    def forward(self, x: Tensor) -> Tensor:
        c0, c1, c2, c3 = self.convs
        h = x.float().permute(2, 0, 1)[None]            # (1, C, h, w)
        h = F.relu(c0(h))
        h = F.relu(c1(h)) + h
        h = F.relu(c2(h))
        head = c3(h)[0].permute(1, 2, 0)
        return torch.clamp(base_blocks(x[..., :3].float()) + head, 0.0, 1.0)


def params_from_flax(tree) -> dict:
    """The JAX package's upscaler params (nested dicts of arrays,
    `Conv_i/{kernel (3,3,I,O) HWIO, bias}`) → an UpscalerNet state dict
    (weights OIHW). Cross-correlation in both, so no kernel flip."""
    state = {}
    for i in range(4):
        conv = tree[f"Conv_{i}"]
        kernel = np.asarray(conv["kernel"], np.float32)
        state[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        state[f"convs.{i}.bias"] = torch.from_numpy(
            np.array(conv["bias"], np.float32))
    return state


def upscaler_from_flax(tree, device=None) -> UpscalerNet:
    """An inference UpscalerNet (no gradients) holding the JAX package's
    params `tree`, on `device` (the card unless given)."""
    state = params_from_flax(tree)
    bc, in_ch = state["convs.0.weight"].shape[:2]
    net = UpscalerNet(in_channels=in_ch, base_channels=bc)
    net.load_state_dict(state)
    net.requires_grad_(False)
    return net.eval().to(resolve_device(device))


def load_upscaler(path=None, device=None) -> Tuple[UpscalerNet, int]:
    """(net, base_channels) from the numpy export (`scripts/
    export_upscaler_npz.py`; default assets/upscaler_2x.npz). Raises if
    the file is missing or its meta fields disagree with the arrays."""
    path = Path(path) if path else DEFAULT_WEIGHTS
    with np.load(path) as z:
        tree, meta = {}, {}
        for key in z.files:
            if "/" in key:
                mod, name = key.split("/", 1)
                tree.setdefault(mod, {})[name] = z[key]
            else:
                meta[key] = int(z[key])
    net = upscaler_from_flax(tree, device)
    bc = int(meta.get("base_channels", net.base_channels))
    in_ch = int(meta.get("in_channels", net.in_channels))
    if (bc, in_ch) != (net.base_channels, net.in_channels):
        raise ValueError(f"{path}: meta base_channels {bc}, in_channels "
                         f"{in_ch} disagree with the arrays")
    return net, bc


def upscaler_in_channels(net: UpscalerNet) -> int:
    """Input channel count from the first conv: 3/4/16/17."""
    return int(net.convs[0].weight.shape[1])


def upscaler_wants_temporal(net: UpscalerNet) -> bool:
    return upscaler_in_channels(net) in (16, 17)


def upscaler_wants_depth(net: UpscalerNet) -> bool:
    return upscaler_in_channels(net) in (4, 17)


def _reproject_half(cur_depth: Tensor, cur_vp_inv: Tensor, prev_vp: Tensor,
                    full_width: int, full_height: int):
    """Half-res pixel centres → previous-frame FULL-res pixel coordinates
    (px, py) + previous clip w. f32 matmuls (TF32 is pinned off)."""
    h, w = cur_depth.shape
    dev = cur_depth.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) \
        * (2.0 / h) - 1.0
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) \
        * (2.0 / w) - 1.0
    ndc_y, ndc_x = torch.meshgrid(ys, xs, indexing="ij")
    ndc = torch.stack([ndc_x, ndc_y, cur_depth, torch.ones_like(ndc_x)],
                      dim=-1)
    world = ndc @ cur_vp_inv.T
    prev_clip = world @ prev_vp.T
    pw = prev_clip[..., 3]
    safe_w = torch.where(pw.abs() < 1e-8, 1e-8, pw)
    px = (prev_clip[..., 0] / safe_w + 1.0) * 0.5 * full_width
    py = (prev_clip[..., 1] / safe_w + 1.0) * 0.5 * full_height
    return px, py, pw


def warp_indices(prev_blocks: Tensor, cur_depth: Tensor, cur_vp_inv: Tensor,
                 prev_vp: Tensor, full_width: int, full_height: int):
    """(by, bx, in_bounds, ok) of the V2 warp: each half-res pixel's source
    block in the (h, w, 12) history, whether it lies inside the history
    in front of the previous camera on geometry, and whether it also fits
    the band window (`band_ok_mask`)."""
    hh, ww2 = prev_blocks.shape[0], prev_blocks.shape[1]
    px, py, pw = _reproject_half(cur_depth, cur_vp_inv, prev_vp,
                                 full_width, full_height)
    bx = torch.round(px * 0.5 - 0.5).to(torch.int32)
    by = torch.round(py * 0.5 - 0.5).to(torch.int32)
    in_bounds = ((bx >= 0) & (bx < ww2) & (by >= 0) & (by < hh)
                 & (pw > 1e-6) & (cur_depth < 1.0))
    ok = band_ok_mask(by, in_bounds, warp_hpad(hh))
    return by, bx, in_bounds, ok


def warp_from_blocks(prev_blocks: Tensor, cur_depth: Tensor,
                     cur_vp_inv: Tensor, prev_vp: Tensor, full_width: int,
                     full_height: int) -> Tensor:
    """V2 warp of the uint8 (h, w, 12) history into the current view →
    (h', w', 13): the 12 history bytes / 255 at each half-res pixel's
    reprojected block, then the validity channel; 0 where invalid."""
    if prev_blocks.dtype != torch.uint8:
        raise NotImplementedError(
            "only the uint8 block history is ported to trident_tpu_torch")
    by, bx, _in_bounds, ok = warp_indices(prev_blocks, cur_depth, cur_vp_inv,
                                          prev_vp, full_width, full_height)
    fetched = warp_fetch(prev_blocks, torch.where(ok, by, -1).contiguous(),
                         torch.where(ok, bx, -1).contiguous())
    valid = ok[..., None].float()
    return torch.cat([fetched * (1.0 / 255.0) * valid, valid], dim=-1)


def temporal_from_prev(net: UpscalerNet, prev, cur_depth: Tensor, camera,
                       out_width: int, out_height: int) -> Optional[Tensor]:
    """The temporal input: `prev` is (previous (h, w, 12) uint8 history,
    previous view·proj) or None. Returns the warp channels for a temporal
    net, or None without history or for a spatial-only net. A 4-channel
    `prev` (the V1 packed-colour history) raises."""
    if prev is None or not upscaler_wants_temporal(net):
        return None
    prev_hist, prev_vp = prev
    if prev_hist.shape[-1] != 12:
        raise NotImplementedError(
            "the V1 full-resolution history is not ported to "
            "trident_tpu_torch")
    # inv_ex: the same inverse as linalg.inv without its error check,
    # which waits for the device
    vp_inv = torch.linalg.inv_ex(camera.proj @ camera.view).inverse
    return warp_from_blocks(prev_hist, cur_depth, vp_inv, prev_vp,
                            out_width, out_height)


def _assemble_inputs(net: UpscalerNet, image: Tensor, temporal, depth):
    parts = [image]
    if upscaler_wants_depth(net):
        if depth is None:
            depth = torch.ones(image.shape[:2], dtype=torch.float32,
                               device=image.device)
        parts.append(depth[..., None].float())
    if upscaler_wants_temporal(net):
        if temporal is None:
            temporal = torch.zeros((*image.shape[:2], WARP_CHANNELS),
                                   dtype=torch.float32, device=image.device)
        parts.append(temporal)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def apply_upscaler_v2(net: UpscalerNet, image: Tensor,
                      temporal: Optional[Tensor] = None,
                      depth: Optional[Tensor] = None):
    """(H, W, 3) [0,1] → (rgb (2H, 2W, 3) f32, blocks (H, W, 12) f32).
    Inputs the net does not want are ignored; wanted-but-missing ones are
    zeros (temporal: validity 0) or background depth 1."""
    blocks = net(_assemble_inputs(net, image, temporal, depth))
    return depth_to_space(blocks), blocks


def psnr(a: Tensor, b: Tensor) -> Tensor:
    mse = torch.mean(torch.square(a - b))
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-10))
