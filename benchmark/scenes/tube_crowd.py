"""The animated crowd on the program: one skinned tube and its looping
clip written as a .glb, imported once through the program's model import,
instanced grid² times with each character playing the clip from its own
phase at its own speed; each step of the traffic is one Scene.update."""

from __future__ import annotations

import os

import numpy as np

from benchmark import gen
from benchmark.reference import tube_crowd as reference
from benchmark.scenes import common


class TubeCrowd:
    """The live scene of a run: `renderer`, `motion` (phases, speeds),
    `step(k)` and `kept(k)` (the palettes the animation system posed)."""

    reference = reference
    KEPT = ("palettes",)             # what kept(k) holds (check.py)

    @staticmethod
    def motion_of(cfg: dict, seed: int, cycle: int):
        """The traffic's motion from the seed."""
        return gen.crowd_motion(cfg, seed)

    def __init__(self, cfg: dict, seed: int, cycle: int, device,
                 workdir: str) -> None:
        from trident_tpu_torch.assets.scene_loader import (
            import_model_entities,
        )
        from trident_tpu_torch.ecs.components import (
            AnimationComponent,
            MeshComponent,
            TextureComponent,
            TransformComponent,
        )
        from trident_tpu_torch.ecs.scene import Scene

        self.motion = self.motion_of(cfg, seed, cycle)
        self.dt = cfg["motion"]["dt"]
        t = cfg["tube"]
        r = self.renderer = common.renderer(cfg, device, workdir)
        self.scene = Scene(renderer=r)
        reg = self.scene.editor_registry
        r.set_active_registry(reg)
        slot = common.texture(r, cfg)
        key_t, key_bend = gen.clip_keys(t["clip_keys"], t["clip_seconds"],
                                        t["clip_amplitude"])
        mesh = gen.tube_mesh(t["segments"], t["rings"], t["bones"],
                             t["length"], t["radius"])
        m = cfg["material"]
        path = gen.write_tube_glb(
            os.path.join(workdir, "tube.glb"), mesh, t["bones"], t["length"],
            key_t, key_bend, dict(base_color=m["base_color"],
                                  metallic=m["metallic"],
                                  roughness=m["roughness"]))
        first = import_model_entities(path, reg, r)
        if len(first) != 1:
            raise ValueError(f"{path}: {len(first)} meshes, expected one")
        mesh0 = reg.get(first[0], MeshComponent)
        positions, scales = gen.crowd_layout(cfg["grid"], cfg["spacing"],
                                             t["scale"], t["length"])
        self.entities = []
        for i, (pos, scale) in enumerate(zip(positions, scales)):
            e = first[0] if i == 0 else reg.create()
            tc = (reg.get(e, TransformComponent) if i == 0
                  else reg.add(e, TransformComponent()))
            tc.position, tc.rotation, tc.scale = (
                np.array(pos), np.zeros(3, np.float32), np.array(scale))
            if i:
                reg.add(e, MeshComponent(mesh_index=mesh0.mesh_index,
                                         material_index=mesh0.material_index))
            reg.add(e, TextureComponent(path="checker", slot=slot))
            reg.add(e, AnimationComponent(
                skeleton_asset=path, animation_asset=path, clip_index=0,
                looping=True))
            self.entities.append(e)
        common.light(reg, cfg)
        common.camera(r, cfg)
        self.scene.play()
        live = self.scene.runtime_registry
        self.anims = [live.get(e, AnimationComponent) for e in self.entities]
        phases, speeds = self.motion
        for anim, phase, speed in zip(self.anims, phases, speeds):
            anim.time, anim.speed = float(phase), float(speed)

    def step(self, k: int) -> None:
        """Frame k of the traffic: one Scene.update of the configuration's
        dt (the animation system poses every character)."""
        self.scene.update(self.dt)

    def kept(self, k: int) -> dict:
        """The palettes the animation system wrote at step k."""
        return {"palettes": [a.bone_matrices for a in self.anims]}

    def close(self) -> None:
        self.scene.stop()

    def span_targets(self) -> list:
        """Scene.update is the animation layer's entry point. Its sampler
        ends in a device-to-host copy, which would wait for the frames
        queued on the card: the span drains the queue first, so that it
        times the animation's own work."""
        return [(self.scene, "update", "anim", True)]


SCENE = TubeCrowd
