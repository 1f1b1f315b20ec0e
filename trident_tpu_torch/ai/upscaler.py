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
run in f32 with TF32 pinned off (package __init__), or, for the V2 path
with dtype "bf16" (the `upscale_dtype` knob, the JAX package's default),
as flax runs `Conv(dtype=bfloat16)`: inputs, kernels and biases rounded
to bf16, each conv accumulated in f32 and rounded to bf16, the bias then
added in bf16, the ReLUs and the residual in bf16, and the head cast back
to f32 over the f32 base. The port's default stays f32
(ops/kernel_knobs.py).

The V1 path is the banded frame's (parallel/framebuffer.py, as the JAX
package's banded frame upscales): `apply_upscaler` adds the head's
depth-to-spaced detail to a 2× bilinear resize of the frame
(`resize_bilinear_2x`, jax.image.resize's weights) and clips, in f32, and
its temporal input is the previous RGBA8 frame reprojected by
`warp_previous`, a plain row gather (the JAX function has no kernel).
The two paths share the net's params. Training runs the V1 forward,
batched (`UpscalerNet.upscale`), as the JAX trainer does
(trident_tpu_torch/scripts/train_upscaler.py).

Weights: `init_upscaler` draws a trainable net as flax initializes the JAX
one; `load_upscaler` reads the numpy export of the shipped checkpoint
(assets/upscaler_2x.npz, written by scripts/export_upscaler_npz.py) or a
directory that `save_upscaler` wrote. The arrays keep their flax names and
layouts; `params_from_flax` maps them onto the module and
`params_to_flax` back.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trident_tpu_torch import resolve_device
from trident_tpu_torch.ai.model import lecun_normal_
from trident_tpu_torch.ops.warp import band_ok_mask, warp_fetch, warp_hpad

Tensor = torch.Tensor

UPSCALER_FILE = "upscaler_2x.npz"   # the file save_upscaler writes in its dir
DEFAULT_WEIGHTS = Path(__file__).resolve().parents[1] / "assets" / \
    UPSCALER_FILE
D2S_MODES = ("convt", "pad", "xla")
UPSCALE_DTYPES = ("bf16", "f32")     # the V2 convs' dtype (upscale_dtype)

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


def depth_to_space(blocks: Tensor, mode: Optional[str] = None) -> Tensor:
    """(…, h, w, 12) → (…, 2h, 2w, 3): an exact relayout of the blocks.
    `mode` names one of the JAX package's three relayouts (convt, pad,
    xla), which it holds bit-exact to each other; each is this one. Any
    other mode raises ValueError."""
    if mode is not None and mode not in D2S_MODES:
        raise ValueError(f"depth_to_space mode {mode!r}: expected "
                         "convt|pad|xla")
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

    def head(self, x: Tensor, dtype: str = "f32") -> Tensor:
        """(h, w, C) or (B, h, w, C) → (…, h, w, 12) f32: the convs'
        residual detail in block layout, before any base is added, with
        the convs in `dtype` (UPSCALE_DTYPES; "bf16" as flax's
        Conv(dtype=bfloat16) runs them, the module note). The convs take
        views of the input: a batch's is channels-last; a frame's, with
        its unit batch dimension strided by C, is not, so the frame path's
        convs stay NCHW."""
        if dtype not in UPSCALE_DTYPES:
            raise ValueError(f"upscale dtype {dtype!r}: expected bf16 | f32")
        batched = x.dim() == 4
        h = x.float().movedim(-1, -3)
        if not batched:
            h = h[None]                                   # (1, C, h, w)
        if dtype == "bf16":
            h = h.to(torch.bfloat16)
        conv = self._conv_bf16 if dtype == "bf16" else (
            lambda i, t: self.convs[i](t))
        h = F.relu(conv(0, h))
        h = F.relu(conv(1, h)) + h
        h = F.relu(conv(2, h))
        out = conv(3, h).float().movedim(-3, -1)
        return out if batched else out[0]

    def _conv_bf16(self, i: int, h: Tensor) -> Tensor:
        """Conv i on a bf16 NCHW tensor as flax's bf16 Conv: bf16 kernel,
        the product accumulated in f32 and rounded to bf16, then the bf16
        bias added (a second rounding)."""
        c = self.convs[i]
        y = F.conv2d(h, c.weight.to(torch.bfloat16), None, padding=1)
        return y + c.bias.to(torch.bfloat16)[:, None, None]

    def forward(self, x: Tensor, dtype: str = "f32") -> Tensor:
        return torch.clamp(base_blocks(x[..., :3].float())
                           + self.head(x, dtype), 0.0, 1.0)

    def upscale(self, x: Tensor) -> Tensor:
        """The V1 forward, what training runs: (h, w, C) or (B, h, w, C)
        assembled inputs → (…, 2h, 2w, 3), the 2× bilinear resize of the
        rgb plus the depth-to-spaced detail, clipped to [0, 1] (the JAX
        UpscalerNet with blocks=False)."""
        return torch.clamp(resize_bilinear_2x(x[..., :3])
                           + depth_to_space(self.head(x)), 0.0, 1.0)


def init_upscaler(generator: torch.Generator, base_channels: int = 32,
                  in_channels: int = 3, device=None) -> UpscalerNet:
    """A trainable UpscalerNet drawn as flax initializes the JAX net
    (trident_tpu/ai/upscaler.py:183): the first three kernels lecun_normal
    from `generator` (flax's draws differ, its distribution is the same),
    every bias and the detail head zero, so the untrained net is the
    bilinear base. Drawn on the CPU, then moved to `device` (the card
    unless given)."""
    net = UpscalerNet(in_channels=in_channels, base_channels=base_channels)
    for conv in net.convs[:3]:
        lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
        nn.init.zeros_(conv.bias)
    return net.to(resolve_device(device))


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


def params_to_flax(net: UpscalerNet) -> dict:
    """The inverse of params_from_flax: `net`'s weights as the JAX
    package's params, `Conv_i/{kernel (3,3,I,O) HWIO, bias}` f32 numpy."""
    tree = {}
    for i, conv in enumerate(net.convs):
        w = conv.weight.detach().cpu().numpy()
        tree[f"Conv_{i}"] = {
            "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "bias": conv.bias.detach().cpu().numpy().copy()}
    return tree


def save_upscaler(net: UpscalerNet, directory) -> Path:
    """Write `net` into `directory` (made if missing) as UPSCALER_FILE, the
    form load_upscaler reads: each array under its flax name
    ("Conv_0/kernel", HWIO), and the meta fields base_channels, scale and
    in_channels as 0-d integers, inferred from the arrays as the JAX
    save_upscaler infers them (trident_tpu/ai/upscaler.py:366-381).
    Returns the file's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tree = params_to_flax(net)
    arrays = {f"{mod}/{name}": a for mod, leaves in tree.items()
              for name, a in leaves.items()}
    kernel = tree["Conv_0"]["kernel"]
    arrays.update(base_channels=np.asarray(kernel.shape[-1], np.int64),
                  scale=np.asarray(2, np.int64),
                  in_channels=np.asarray(kernel.shape[-2], np.int64))
    path = directory / UPSCALER_FILE
    np.savez(path, **arrays)
    return path


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
    export_upscaler_npz.py`; default assets/upscaler_2x.npz), or from the
    UPSCALER_FILE in a directory that save_upscaler wrote. Raises if the
    file is missing or its meta fields disagree with the arrays."""
    path = Path(path) if path else DEFAULT_WEIGHTS
    if path.is_dir():
        path = path / UPSCALER_FILE
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


def _warp_blocks(hh: int, ww2: int, cur_depth: Tensor, cur_vp_inv: Tensor,
                 prev_vp: Tensor, full_width: int, full_height: int):
    """(by, bx, in_bounds): each half-res pixel's source block in an
    (hh, ww2, 12) history, and whether it lies inside the history in
    front of the previous camera on geometry."""
    px, py, pw = _reproject_half(cur_depth, cur_vp_inv, prev_vp,
                                 full_width, full_height)
    bx = torch.round(px * 0.5 - 0.5).to(torch.int32)
    by = torch.round(py * 0.5 - 0.5).to(torch.int32)
    in_bounds = ((bx >= 0) & (bx < ww2) & (by >= 0) & (by < hh)
                 & (pw > 1e-6) & (cur_depth < 1.0))
    return by, bx, in_bounds


def warp_indices(prev_blocks: Tensor, cur_depth: Tensor, cur_vp_inv: Tensor,
                 prev_vp: Tensor, full_width: int, full_height: int,
                 windowed: bool = True):
    """(by, bx, in_bounds, ok) of the V2 warp: each half-res pixel's source
    block in the (h, w, 12) history, whether it lies inside the history
    in front of the previous camera on geometry, and whether it is
    fetched: where it also fits the TPU kernel's band window
    (`band_ok_mask`; the `warp_mxu` knob on), or wherever it is in bounds
    (`windowed` False: the JAX package's XLA row gather,
    trident_tpu/ai/upscaler.py:259-264)."""
    hh = prev_blocks.shape[0]
    by, bx, in_bounds = _warp_blocks(hh, prev_blocks.shape[1], cur_depth,
                                     cur_vp_inv, prev_vp, full_width,
                                     full_height)
    ok = (band_ok_mask(by, in_bounds, warp_hpad(hh)) if windowed
          else in_bounds)
    return by, bx, in_bounds, ok


def warp_from_blocks(prev_blocks: Tensor, cur_depth: Tensor,
                     cur_vp_inv: Tensor, prev_vp: Tensor, full_width: int,
                     full_height: int, windowed: bool = True) -> Tensor:
    """V2 warp of the (h, w, 12) history into the current view → (h', w',
    13): the history at each half-res pixel's reprojected block, then the
    validity channel; 0 where invalid. A uint8 history (bytes / 255) goes
    through the warp kernel, valid inside the band window, or with
    `windowed` False (the `warp_mxu` knob off) wherever it is in bounds
    (`warp_indices`), bit-equal to the JAX package's row gather then; a
    float history is a plain clipped row gather, valid wherever
    `in_bounds` holds (trident_tpu/ai/upscaler.py:259-264: the JAX
    package's kernel takes only the uint8 history)."""
    if prev_blocks.dtype != torch.uint8:
        hh, ww2 = prev_blocks.shape[0], prev_blocks.shape[1]
        by, bx, in_bounds = _warp_blocks(hh, ww2, cur_depth, cur_vp_inv,
                                         prev_vp, full_width, full_height)
        block = prev_blocks.float()[torch.clamp(by, 0, hh - 1).long(),
                                    torch.clamp(bx, 0, ww2 - 1).long()]
        valid = in_bounds[..., None].float()
        return torch.cat([block * valid, valid], dim=-1)
    by, bx, _in_bounds, ok = warp_indices(prev_blocks, cur_depth, cur_vp_inv,
                                          prev_vp, full_width, full_height,
                                          windowed)
    fetched = warp_fetch(prev_blocks, torch.where(ok, by, -1).contiguous(),
                         torch.where(ok, bx, -1).contiguous())
    valid = ok[..., None].float()
    return torch.cat([fetched * (1.0 / 255.0) * valid, valid], dim=-1)


def warp_previous(prev_rgb: Tensor, cur_depth: Tensor, cur_vp_inv: Tensor,
                  prev_vp: Tensor, full_width: int,
                  full_height: int) -> Tensor:
    """V1 warp (trident_tpu/ai/upscaler.py:267-293): the previous
    full-resolution frame prev_rgb (H, W, 3) f32 reprojected into the
    current view at the half-res grid of cur_depth (h, w) → (h, w, 13):
    the 2×2 full-res block under each reprojected point (space-to-depth,
    channel (dy·2+dx)·3+c) and a validity channel, 0 where the point
    leaves the frame, lies behind the previous camera or is background. A
    plain row gather; matrices are the full frame's view·proj (current
    inverted)."""
    hh, ww2 = prev_rgb.shape[0] // 2, prev_rgb.shape[1] // 2
    s2d = prev_rgb[:hh * 2, :ww2 * 2].reshape(hh, 2, ww2, 2, 3) \
        .permute(0, 2, 1, 3, 4).reshape(hh, ww2, 12)
    by, bx, in_bounds = _warp_blocks(hh, ww2, cur_depth, cur_vp_inv,
                                     prev_vp, full_width, full_height)
    block = s2d[torch.clamp(by, 0, hh - 1).long(),
                torch.clamp(bx, 0, ww2 - 1).long()]
    valid = in_bounds[..., None].float()
    return torch.cat([block * valid, valid], dim=-1)


def temporal_from_prev(net: UpscalerNet, prev, cur_depth: Tensor, camera,
                       out_width: int, out_height: int,
                       windowed: bool = True) -> Optional[Tensor]:
    """The temporal input: `prev` is (previous history, previous
    view·proj) or None. The history is the V2 (h, w, 12) uint8 blocks
    (warp_from_blocks, `windowed` as it takes it) or the V1
    full-resolution frame, (H, W, ≥3) RGBA8 or f32, whose rgb
    warp_previous reprojects (uint8 scaled by 1/255): the channel count
    decides, so the first frame after a change of path still warps.
    Returns the warp channels for a temporal net, or None without history
    or for a spatial-only net."""
    if prev is None or not upscaler_wants_temporal(net):
        return None
    prev_hist, prev_vp = prev
    # inv_ex: the same inverse as linalg.inv without its error check,
    # which waits for the device
    vp_inv = torch.linalg.inv_ex(camera.proj @ camera.view).inverse
    if prev_hist.shape[-1] == 12:
        return warp_from_blocks(prev_hist, cur_depth, vp_inv, prev_vp,
                                out_width, out_height, windowed)
    prev_rgb = prev_hist[..., :3]
    if prev_rgb.dtype == torch.uint8:
        prev_rgb = prev_rgb.float() * (1.0 / 255.0)
    return warp_previous(prev_rgb, cur_depth, vp_inv, prev_vp, out_width,
                         out_height)


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


def _resize_axis_2x(v: Tensor, axis: int) -> Tensor:
    """2× linear upsampling along `axis` with jax.image.resize's
    "bilinear" weights (half-pixel centres, triangle kernel): output 2i
    samples input i − 0.25 (0.25·v[i−1] + 0.75·v[i]), output 2i+1 input
    i + 0.25 (0.75·v[i] + 0.25·v[i+1]), each sum in ascending input
    order; at the two ends the one in-range weight normalizes to 1, so the
    end samples are copies."""
    n = v.shape[axis]
    lo = v.narrow(axis, 0, n - 1)
    hi = v.narrow(axis, 1, n - 1)
    even = torch.cat([v.narrow(axis, 0, 1), 0.25 * lo + 0.75 * hi],
                     dim=axis)
    odd = torch.cat([0.75 * lo + 0.25 * hi, v.narrow(axis, n - 1, 1)],
                    dim=axis)
    out = torch.stack([even, odd], dim=axis + 1)
    return out.reshape(*v.shape[:axis], 2 * n, *v.shape[axis + 1:])


def resize_bilinear_2x(rgb: Tensor) -> Tensor:
    """(…, h, w, C) → (…, 2h, 2w, C): jax.image.resize(…, "bilinear") at
    2×, rows then columns, in f32. XLA evaluates each axis as a dot over a
    weight matrix whose accumulation order follows its blocking, so the
    two agree within an ulp or two per axis, not bit for bit."""
    n = rgb.dim()
    return _resize_axis_2x(_resize_axis_2x(rgb.float(), n - 3), n - 2)


def apply_upscaler(net: UpscalerNet, image: Tensor,
                   temporal: Optional[Tensor] = None,
                   depth: Optional[Tensor] = None) -> Tensor:
    """V1 (trident_tpu/ai/upscaler.py:320-332): (H, W, 3) [0,1] → (2H, 2W,
    3) f32, the 2× bilinear resize of `image` plus the net's
    depth-to-spaced detail, clipped to [0, 1]. `temporal` is the (H, W,
    13) warp_previous output; inputs as apply_upscaler_v2 takes them."""
    return net.upscale(_assemble_inputs(net, image, temporal, depth))


def apply_upscaler_v2(net: UpscalerNet, image: Tensor,
                      temporal: Optional[Tensor] = None,
                      depth: Optional[Tensor] = None, dtype: str = "f32",
                      d2s_mode: Optional[str] = None):
    """(H, W, 3) [0,1] → (rgb (2H, 2W, 3) f32, blocks (H, W, 12) f32),
    the convs in `dtype` (the `upscale_dtype` knob), the display frame
    by depth_to_space(mode=d2s_mode). Inputs the net does not want are
    ignored; wanted-but-missing ones are zeros (temporal: validity 0) or
    background depth 1."""
    blocks = net(_assemble_inputs(net, image, temporal, depth), dtype)
    return depth_to_space(blocks, d2s_mode), blocks


def upscaler_flops(base_channels: int, in_channels: int, height: int,
                   width: int) -> int:
    """Multiply-adds × 2 of one forward pass of the net's four 3×3 convs on
    an (height, width) input (the half-size frame); ReLUs, the residual,
    the base and the clip are not counted."""
    c = base_channels
    return 2 * 9 * height * width * (in_channels * c + 2 * c * c + c * 12)


def psnr(a: Tensor, b: Tensor) -> Tensor:
    mse = torch.mean(torch.square(a - b))
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-10))
