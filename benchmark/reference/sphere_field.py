"""The sphere field's plain reference: frame k of a run, from the
configuration and the traffic's rotations alone."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import gen
from benchmark.reference import common, raster, transforms


def frame_mesh(cfg: dict, rotation, device, control: bool = False):
    """(raster.Mesh, raster.Shading) of the field with every sphere turned
    to `rotation` (Euler degrees)."""
    sph = cfg["sphere"]
    m = gen.uv_sphere(sph["rings"], sph["segments"], sph["radius"])
    pos = gen.field_positions(cfg["grid"], cfg["spacing"])
    models = torch.tensor(transforms.trs(pos, np.asarray(rotation)[None],
                                         np.ones(3)),
                          dtype=torch.float32, device=device)
    n = pos.shape[0]

    def t(a):
        return torch.as_tensor(a, device=device)

    mesh = common.place(cfg, models, t(m["positions"]).expand(n, -1, -1),
                        t(m["normals"]).expand(n, -1, -1), t(m["uvs"]),
                        None, t(m["indices"]).long().view(-1, 3), control)
    return mesh, common.shading(cfg)


def reference_frame(cfg: dict, motion, k: int, device,
                    control: bool = False, given=None) -> dict:
    """render()'s frame after the traffic's step k (rotation row
    k % cycle), and nothing else to compare. The field's frames take in
    nothing from earlier frames: `given` is empty."""
    mesh, shading = frame_mesh(cfg, motion[k % len(motion)], device, control)
    out = raster.render(mesh, shading, cfg["width"], cfg["height"])
    out["mesh"] = mesh
    return out
