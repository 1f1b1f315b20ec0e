"""What the reference scenes share: the shading of a configuration and
placing posed vertices in clip space."""

from __future__ import annotations

import torch

from benchmark import gen
from benchmark.reference import raster, transforms


def shading(cfg: dict) -> raster.Shading:
    """The configuration's material, texture chain, lights, eye and clear
    colour."""
    tex, mat, light = cfg["texture"], cfg["material"], cfg["light"]
    img = gen.checker(tex["size"], tex["cells"], tex["color_a"],
                      tex["color_b"])
    return raster.Shading(
        base_color=tuple(mat["base_color"]), metallic=mat["metallic"],
        roughness=mat["roughness"], ambient_strength=mat["ambient"],
        mips=raster.mip_chain(img), light_dir=tuple(light["direction"]),
        light_color=tuple(light["color"]),
        light_intensity=light["intensity"], ambient=tuple(light["ambient"]),
        camera_pos=tuple(cfg["camera"]["position"]),
        clear_color=tuple(cfg["clear_color"]))


def place(cfg: dict, models: torch.Tensor, positions: torch.Tensor,
          normals: torch.Tensor, uvs: torch.Tensor, colors, tris: torch.Tensor,
          control: bool) -> raster.Mesh:
    """Instance n of a mesh at model matrix models[n] (N, 4, 4): posed
    vertices `positions` (N, V, 3) and `normals` (N, V, 3) (one pose per
    instance) → world, unit world normals (cof(M)·n) and clip positions of
    all N·V vertices, the triangles (T, 3) repeated per instance."""
    dev = positions.device
    n, v = positions.shape[:2]
    ones = torch.ones((n, v, 1), dtype=torch.float32, device=dev)
    world_h = raster.matmul(torch.cat([positions, ones], -1),
                            models.transpose(1, 2), control)
    proj, view, _eye = transforms.camera(cfg["camera"], cfg["width"],
                                         cfg["height"], dev)
    vp = raster.matmul(proj, view, control)
    clip = raster.matmul(world_h.reshape(-1, 4), vp.T, control)
    cof = raster.cofactor3(models[:, :3, :3])
    nrm = raster.normalize(raster.matmul(normals, cof.transpose(1, 2),
                                         control))
    offsets = (torch.arange(n, device=dev) * v)[:, None, None]
    return raster.Mesh(
        clip=clip, world=world_h[..., :3].reshape(-1, 3),
        normal=nrm.reshape(-1, 3), uv=uvs.repeat(n, 1),
        color=None if colors is None else colors.repeat(n, 1),
        tris=(tris[None] + offsets).reshape(-1, 3))
