"""The upscaled field's plain reference: frame k of a run rendered at half
the configuration's width and height and rebuilt at its full size by the
temporal 2× net whose weights the configuration names (`upscaler`, a
numpy archive read with numpy: `Conv_<i>/kernel` (3, 3, in, out) and
`Conv_<i>/bias`), in plain float32 torch with TF32 off; under `control`
every matmul and conv is TF32-rounded instead.

The net (trident_tpu/ai/upscaler.py's V2 path, as the program states it):
the input is 16 channels at each half-size pixel, the colour (3), the
previous frame's 12 history bytes at the pixel's reprojected block over
255 (12) and their validity (1), 0 where invalid; four 3×3 convs with
padding 1 (16 → 32 → 32 → 32 → 12), ReLUs after the first three and a
residual around the second; the 12-channel head is added to the 2×
bilinear base in block layout (channel (dy·2 + dx)·3 + c is display pixel
(2y + dy, 2x + dx), the base 0.75·v[i] + 0.25·v[i ∓ 1] along each axis,
edges clamped) and clipped to [0, 1]. The blocks, rounded to bytes (half
to even), are the next frame's history; the display frame is one
depth-to-space of them, alpha repeated 2×2.

The warp (the program's K8 and its index arithmetic): each half-size
pixel centre at its own depth (the winner's z / w) is carried through the
inverse of this view·proj and the previous frame's view·proj to the
previous full-size frame, and its history block is the one at
round(p / 2 − ½) on each axis (half to even). It is valid where that
block lies inside the history, the previous clip w exceeds 1e-6 and the
pixel is on geometry (depth < 1). Departure from K8: no band window (the
program keeps the TPU kernel's two 32-row bands per 8×256 block, which
drop no pixel under a camera that holds still, as the field's does).

Stages (benchmark/check.py): given the program's `colour` and `depth`
(the half-size colour its net read and the depth its warp read), the
given history is warped by that depth and the net runs on that colour:
`blocks`, held to the program's history element by element. The two
rasters part at edges, and a validity that parted with them would move
a pixel's blocks through the net's 9×9 reach: warped by this reference's
own depth, 4.1–4.7% of a sound run's blocks differ, against 6.5–6.7%
for a net in bf16 (H100; PERF.md §6), which the limit could not tell
apart. The display frame `color` is this reference's own chain: its
render, its warp by its own depth, its net. `colour` and `depth` are its
own render's. Without given history nothing is warped (validity 0), as
the program's first frame.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import raster, sphere_field, transforms

CHECKOUT = Path(__file__).resolve().parents[2]
CONVS = 4


def half_config(cfg: dict) -> dict:
    """The configuration at the size the frame renders at."""
    return dict(cfg, width=cfg["width"] // 2, height=cfg["height"] // 2)


def net_params(cfg: dict, device) -> list:
    """The configuration's net: (weight (out, in, 3, 3), bias) f32 per
    conv, read with numpy from `upscaler` (relative to the checkout)."""
    with np.load(CHECKOUT / cfg["upscaler"]) as z:
        return [(torch.tensor(z[f"Conv_{i}/kernel"].transpose(3, 2, 0, 1),
                              dtype=torch.float32, device=device),
                 torch.tensor(z[f"Conv_{i}/bias"], dtype=torch.float32,
                              device=device)) for i in range(CONVS)]


def shade(mesh: raster.Mesh, s: raster.Shading, width: int,
          height: int) -> dict:
    """raster.render's frame (the field has no vertex colours) before its
    colour is rounded to bytes: {"rgba": (H, W, 4) f32, "depth", "tri"}:
    the net reads the float colour."""
    vis = raster.visibility(mesh.clip, mesh.tris, width, height)
    dev = mesh.clip.device
    flat_tri = vis.tri.reshape(-1)
    pix = torch.nonzero(flat_tri >= 0).squeeze(1)
    t = flat_tri[pix]
    pxf = (pix % width).float() + 0.5
    pyf = (pix // width).float() + 0.5
    e = vis.edges[t]
    ev = e[..., 0] * pxf[:, None] + e[..., 1] * pyf[:, None] + e[..., 2]
    g = ev.sum(1, keepdim=True)
    g = torch.where(g.abs() < 1e-20, 1e-20, g)
    lam = ev / g
    corners = mesh.tris[t]

    def interp(attr):
        return (lam[..., None] * attr[corners]).sum(1)

    normal = raster.normalize(interp(mesh.normal))
    world = interp(mesh.world)
    uv = interp(mesh.uv)
    uvc = mesh.uv[corners]
    gx = e[..., 0].sum(1, keepdim=True)
    gy = e[..., 1].sum(1, keepdim=True)
    du_dx = ((e[..., 0:1] * uvc).sum(1) - uv * gx) / g
    du_dy = ((e[..., 1:2] * uvc).sum(1) - uv * gy) / g
    size = float(s.mips[0].shape[0])
    rho = torch.maximum((du_dx * size).square().sum(1),
                        (du_dy * size).square().sum(1))
    mip = 0.5 * torch.log2(torch.clamp_min(rho, 1e-12))
    level = torch.round(torch.clamp(mip, 0.0, float(len(s.mips) - 1))).long()
    texel = raster.sample_bilinear(s.mips, uv, level)
    base = torch.tensor(s.base_color, dtype=torch.float32, device=dev)
    cf = base.expand(t.shape[0], 4)
    albedo = texel[:, :3] * cf[:, :3]
    alpha = cf[:, 3:4] * texel[:, 3:4]
    lit = raster.pbr(world, normal, albedo, s)
    c = lit / (lit + 1.0)
    rgb = torch.pow(torch.clamp_min(c, 0.0), 1.0 / 2.2)
    out = torch.tensor(s.clear_color, dtype=torch.float32,
                       device=dev).repeat(height * width, 1)
    out[pix] = torch.cat([rgb, alpha], dim=1)
    return {"rgba": out.view(height, width, 4), "depth": vis.depth,
            "tri": vis.tri}


def view_proj(cfg: dict, device, control: bool) -> torch.Tensor:
    """The configuration camera's proj · view (the aspect is the half
    size's, the display's)."""
    proj, view, _eye = transforms.camera(cfg["camera"], cfg["width"],
                                         cfg["height"], device)
    return raster.matmul(proj, view, control)


def warp(history: torch.Tensor, prev_vp: torch.Tensor, depth: torch.Tensor,
         vp: torch.Tensor, control: bool) -> torch.Tensor:
    """(h, w, 13): the (h, w, 12) uint8 history at each pixel's reprojected
    block over 255, then the validity, 0 where invalid (module note)."""
    h, w = depth.shape
    dev = depth.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) \
        * (2.0 / h) - 1.0
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) \
        * (2.0 / w) - 1.0
    ndc_y, ndc_x = torch.meshgrid(ys, xs, indexing="ij")
    ndc = torch.stack([ndc_x, ndc_y, depth, torch.ones_like(depth)], -1)
    world = raster.matmul(ndc.view(-1, 4), torch.linalg.inv(vp).T, control)
    clip = raster.matmul(world, prev_vp.to(dev).T, control).view(h, w, 4)
    pw = clip[..., 3]
    safe_w = torch.where(pw.abs() < 1e-8, 1e-8, pw)
    px = (clip[..., 0] / safe_w + 1.0) * 0.5 * (2 * w)
    py = (clip[..., 1] / safe_w + 1.0) * 0.5 * (2 * h)
    bx = torch.round(px * 0.5 - 0.5).long()
    by = torch.round(py * 0.5 - 0.5).long()
    hh, hw = history.shape[:2]
    valid = ((bx >= 0) & (bx < hw) & (by >= 0) & (by < hh) & (pw > 1e-6)
             & (depth < 1.0))
    block = history.to(dev)[by.clamp(0, hh - 1), bx.clamp(0, hw - 1)]
    v = valid[..., None].float()
    return torch.cat([block.float() * (1.0 / 255.0) * v, v], -1)


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
         control: bool) -> torch.Tensor:
    """A 3×3 conv, padding 1, in float32 with TF32 off; under `control`
    its input and weights rounded to TF32 first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if control:
        x, w = raster.tf32(x), raster.tf32(w)
    return F.conv2d(x, w, b, padding=1)


def base_blocks(rgb: torch.Tensor) -> torch.Tensor:
    """(h, w, 3) → (h, w, 12): the 2× bilinear base in block layout."""
    def phases(v, axis):
        n = v.shape[axis]
        lo = torch.cat([v.narrow(axis, 0, 1), v.narrow(axis, 0, n - 1)],
                       axis)
        hi = torch.cat([v.narrow(axis, 1, n - 1), v.narrow(axis, n - 1, 1)],
                       axis)
        return 0.75 * v + 0.25 * lo, 0.75 * v + 0.25 * hi

    out = []
    for vy in phases(rgb, 0):
        out += list(phases(vy, 1))
    return torch.cat(out, -1)


def net_blocks(params: list, rgb: torch.Tensor, temporal: torch.Tensor,
               control: bool) -> torch.Tensor:
    """(h, w, 12) f32 blocks in [0, 1] of the net over the colour and the
    warped history."""
    x = torch.cat([rgb, temporal], -1).movedim(-1, 0)[None]
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = params
    h = F.relu(conv(x, w0, b0, control))
    h = F.relu(conv(h, w1, b1, control)) + h
    h = F.relu(conv(h, w2, b2, control))
    head = conv(h, w3, b3, control)[0].movedim(0, -1)
    return torch.clamp(base_blocks(rgb) + head, 0.0, 1.0)


def to_bytes(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x * 255.0).to(torch.uint8)


def display(blocks: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """(2h, 2w, 4) uint8: the blocks' depth-to-space, alpha repeated."""
    h, w = blocks.shape[:2]
    rgb = blocks.view(h, w, 2, 2, 3).permute(0, 2, 1, 3, 4).reshape(
        2 * h, 2 * w, 3)
    a = alpha.repeat_interleave(2, 0).repeat_interleave(2, 1)
    return to_bytes(torch.clamp(torch.cat([rgb, a[..., None]], -1), 0.0,
                                1.0))


def reference_frame(cfg: dict, motion, k: int, device,
                    control: bool = False, given=None, kept=None) -> dict:
    """The display frame `color` after the traffic's step k (rotation row
    k % cycle) from the given previous `history` and `view_proj` (none:
    nothing warped), its own half-size `colour` and `depth` and, given the
    program's kept `colour` and `depth`, the net's `blocks` on them; with
    `mesh` and `tri`, the half-size frame's, for the raster work."""
    given = given or {}
    half = half_config(cfg)
    mesh, shading = sphere_field.frame_mesh(half, motion[k % len(motion)],
                                            device, control)
    own = shade(mesh, shading, half["width"], half["height"])
    params = net_params(cfg, device)
    vp = view_proj(half, device, control)

    def temporal(depth):
        if "history" not in given:
            return torch.zeros((*depth.shape, 13), dtype=torch.float32,
                               device=device)
        return warp(given["history"], given["view_proj"], depth, vp,
                    control)

    rgb, alpha = own["rgba"][..., :3], own["rgba"][..., 3]
    out = {"color": display(net_blocks(params, rgb, temporal(own["depth"]),
                                       control), alpha),
           "colour": rgb, "depth": own["depth"], "mesh": mesh,
           "tri": own["tri"]}
    if kept is not None:
        colour, depth = (torch.as_tensor(kept[n], device=device).float()
                         for n in ("colour", "depth"))
        out["blocks"] = to_bytes(net_blocks(params, colour, temporal(depth),
                                            control))
    return out
