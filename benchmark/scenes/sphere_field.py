"""The sphere field on the program: one UV sphere mesh instanced on a
grid, one checker texture, one directional light, the editor camera; each
step of the traffic turns every entity to that frame's rotation."""

from __future__ import annotations

import numpy as np

from benchmark import gen
from benchmark.reference import sphere_field as reference
from benchmark.scenes import common


class SphereField:
    """The live scene of a run: `renderer`, `motion` (the traffic's
    rotation rows), `step(k)` and `kept(k)`."""

    reference = reference

    @staticmethod
    def motion_of(cfg: dict, seed: int, cycle: int):
        """The traffic's motion from the seed."""
        return gen.field_motion(cfg, seed, cycle)

    def __init__(self, cfg: dict, seed: int, cycle: int, device,
                 workdir: str) -> None:
        from trident_tpu_torch.ecs.components import (
            MeshComponent,
            TextureComponent,
            TransformComponent,
        )
        from trident_tpu_torch.ecs.registry import Registry
        from trident_tpu_torch.geometry.mesh import Mesh

        self.motion = self.motion_of(cfg, seed, cycle)
        r = self.renderer = common.renderer(cfg, device, workdir)
        slot = common.texture(r, cfg)
        sph = cfg["sphere"]
        m = gen.uv_sphere(sph["rings"], sph["segments"], sph["radius"])
        mesh_idx, mat_idx = r.append_meshes(
            [Mesh(m["positions"], m["indices"], normals=m["normals"],
                  uvs=m["uvs"], name="sphere")], [common.material(cfg)])
        reg = Registry()
        r.set_active_registry(reg)
        self.transforms = []
        for p in gen.field_positions(cfg["grid"], cfg["spacing"]):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array(p, np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh_idx,
                                     material_index=mat_idx))
            reg.add(e, TextureComponent(path="checker", slot=slot))
            self.transforms.append(t)
        common.light(reg, cfg)
        common.camera(r, cfg)

    def step(self, k: int) -> None:
        """Frame k of the traffic: every entity to rotation row k % cycle
        (rows computed in set-up, only assigned here)."""
        rot = self.motion[k % len(self.motion)]
        for t in self.transforms:
            t.rotation = rot

    def kept(self, k: int) -> dict:
        """What the program made at step k besides the frame: nothing."""
        return {}

    def close(self) -> None:
        pass

    def span_targets(self) -> list:
        return []


SCENE = SphereField
