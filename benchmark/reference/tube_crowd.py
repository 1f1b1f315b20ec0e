"""The animated crowd's plain reference: each character's pose sampled
from the clip at its own time, linear-blend skinning with four
influences, then the frame."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import gen
from benchmark.reference import common, raster, transforms


def palettes(cfg: dict, times: np.ndarray, device,
             control: bool = False) -> torch.Tensor:
    """(N, bones, 4, 4) skinning matrices of N characters at clip times
    `times`: the key bends interpolated linearly (turns about one axis
    slerp as their angles lerp), every joint but the root turned by
    bend/(bones − 1) about z at the end of its parent's segment, the
    chain walked root first, each joint's matrix times its inverse
    bind."""
    t = cfg["tube"]
    bones, length = t["bones"], t["length"]
    key_t, key_bend = gen.clip_keys(t["clip_keys"], t["clip_seconds"],
                                    t["clip_amplitude"])
    bend = np.interp(np.asarray(times, np.float64),
                     key_t.astype(np.float64), key_bend)
    theta = bend / max(bones - 1, 1)
    seg = length / max(bones - 1, 1)
    n = len(times)
    local = np.tile(np.eye(4), (n, 1, 1))
    c, s = np.cos(theta), np.sin(theta)
    local[:, 0, 0], local[:, 0, 1], local[:, 1, 0], local[:, 1, 1] = \
        c, -s, s, c
    local[:, 1, 3] = seg
    f32 = dict(dtype=torch.float32, device=device)
    local = torch.tensor(local, **f32)
    inv_bind = torch.eye(4, **f32).repeat(bones, 1, 1)
    inv_bind[:, 1, 3] = -seg * torch.arange(bones, **f32)
    joint = [torch.eye(4, **f32).expand(n, 4, 4)]
    for _ in range(1, bones):
        joint.append(raster.matmul(joint[-1], local, control))
    glob = torch.stack(joint, dim=1)                          # (N, B, 4, 4)
    return raster.matmul(glob, inv_bind, control)


def frame_mesh(cfg: dict, times: np.ndarray, device, control: bool = False):
    """(raster.Mesh, raster.Shading, palettes) of the crowd posed at clip
    times `times`, one per character."""
    t = cfg["tube"]
    m = gen.tube_mesh(t["segments"], t["rings"], t["bones"], t["length"],
                      t["radius"])
    pos, scale = gen.crowd_layout(cfg["grid"], cfg["spacing"], t["scale"],
                                  t["length"])
    models = torch.tensor(transforms.trs(pos, np.zeros(3), scale),
                          dtype=torch.float32, device=device)
    pal = palettes(cfg, times, device, control)               # (N, B, 4, 4)

    def tt(a):
        return torch.as_tensor(a, device=device)

    idx, w = tt(m["bone_indices"]).long(), tt(m["bone_weights"])
    used = (w > 0.0) & (idx >= 0) & (idx < t["bones"])
    w = torch.where(used, w, 0.0)
    mats = pal[:, idx.clamp(0, t["bones"] - 1)]               # (N, V, 4, 4, 4)
    skin = (w[None, :, :, None, None] * mats).sum(2)          # (N, V, 4, 4)
    p = tt(m["positions"])
    ph = torch.cat([p, torch.ones_like(p[:, :1])], -1)
    posed = raster.matmul(skin, ph.expand(len(times), -1, -1)[..., None],
                          control)[..., :3, 0]
    nrm = raster.matmul(skin[..., :3, :3],
                        tt(m["normals"]).expand(len(times), -1, -1)[..., None],
                        control)[..., 0]
    mesh = common.place(cfg, models, posed, nrm, tt(m["uvs"]),
                        tt(m["colors"]), tt(m["indices"]).long().view(-1, 3),
                        control)
    return mesh, common.shading(cfg), pal


def reference_frame(cfg: dict, motion, k: int, device,
                    control: bool = False, given=None) -> dict:
    """render()'s frame after the traffic's step k (k + 1 animation
    updates of the configuration's dt since play), with the palettes.
    The crowd's frames take in nothing from earlier frames: `given` is
    empty."""
    phases, speeds = motion
    t = cfg["tube"]
    times = gen.clip_times(phases, speeds, cfg["motion"]["dt"],
                           t["clip_seconds"], k + 1)
    mesh, shading, pal = frame_mesh(cfg, times, device, control)
    out = raster.render(mesh, shading, cfg["width"], cfg["height"])
    out["palettes"] = pal
    out["mesh"] = mesh
    return out
