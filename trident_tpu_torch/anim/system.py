"""ECS AnimationSystem: drives AnimationComponents each runtime frame.

Port of trident_tpu/anim/system.py. Reference: ECS/AnimationSystem.h +
ECS/Components/AnimationSystem.cpp — per entity: refresh cached handles
when asset ids change, drive the state machine if present else a clip
player, write the pose into AnimationComponent.bone_matrices (consumed by
the renderer's bone palette).

Clip-driven entities are posed by the batched sampler (anim/batch.py) on
the device the caller names (`device`, the card when None; the Scene passes
its renderer's device), one call per (skeleton, clip) group.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from trident_tpu_torch import resolve_device
from trident_tpu_torch.anim.batch import BatchedClipSampler
from trident_tpu_torch.anim.player import AnimationPlayer
from trident_tpu_torch.anim.service import AnimationAssetService
from trident_tpu_torch.ecs.components import AnimationComponent
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.utils.profiling import TRACER


class AnimationSystem:
    _players: Dict[int, AnimationPlayer] = {}
    _samplers: "Optional[OrderedDict[tuple, BatchedClipSampler]]" = None
    _SAMPLER_CAP = 32     # baked keyframe tables per live cache entry —
                          # bound it so load/unload cycles don't pin every
                          # clip ever seen (each entry also strong-refs its
                          # skeleton/clip)

    @classmethod
    def _player_for(cls, entity: int, anim: AnimationComponent) -> Optional[AnimationPlayer]:
        service = AnimationAssetService.get()
        skeleton = service.acquire_skeleton(anim.skeleton_asset)
        if skeleton is None:
            return None
        player = cls._players.get(entity)
        if player is None or player.skeleton is not skeleton:
            player = AnimationPlayer(skeleton)
            cls._players[entity] = player
        clips = service.acquire_animation_library(anim.animation_asset or anim.skeleton_asset)
        clip_idx = anim.clip_index
        if anim.clip_name:
            named = service.resolve_clip_index(
                anim.animation_asset or anim.skeleton_asset, anim.clip_name)
            if named >= 0:
                clip_idx = named
        if 0 <= clip_idx < len(clips) and player.clip is not clips[clip_idx]:
            player.set_clip(clips[clip_idx], reset_time=False)
        return player

    @classmethod
    def initialise_pose(cls, registry: Registry, device=None) -> None:
        """Emit bind/first poses on Play so skinned meshes never render
        un-posed (reference InitialisePose): each clip-driven entity at its
        current time, sampled by group on `device` as update does."""
        groups: Dict[tuple, list] = {}
        for entity, (anim,) in registry.view(AnimationComponent):
            if anim.state_machine is not None:
                anim.bone_matrices = np.asarray(anim.state_machine.update(0.0))
                continue
            player = cls._player_for(entity, anim)
            if player is None:
                continue
            if player.clip is None:
                anim.bone_matrices = player.evaluate_at(anim.time).copy()
                continue
            groups.setdefault((id(player.skeleton), id(player.clip)), []) \
                .append((anim, player, player._wrap(anim.time)))
        cls._sample_groups(groups, device)

    @classmethod
    def _sampler_for(cls, skeleton, clip, device) -> BatchedClipSampler:
        if cls._samplers is None:
            cls._samplers = OrderedDict()
        # identity keys are safe here BECAUSE entries strong-ref their
        # skeleton/clip (live keys can't be id-recycled); the LRU cap is
        # what lets dead assets actually be released
        key = (id(skeleton), id(clip), str(device))
        sampler = cls._samplers.get(key)
        if sampler is None or sampler.skeleton is not skeleton \
                or sampler.clip is not clip:
            sampler = BatchedClipSampler(clip, skeleton, device)
            cls._samplers[key] = sampler
        cls._samplers.move_to_end(key)
        while len(cls._samplers) > cls._SAMPLER_CAP:
            cls._samplers.popitem(last=False)
        return sampler

    @classmethod
    def _sample_groups(cls, groups: Dict[tuple, list], device) -> None:
        """One sampler call per group of (anim, player, wrapped time)
        items; each palette goes to its component and its player."""
        if not groups:
            return
        device = resolve_device(device)
        # the LRU cap must exceed the LIVE group count or every frame
        # evicts-and-rebuilds all samplers in rotation (a full host table
        # bake per group per frame); grow it to fit — the cap still bounds
        # dead load/unload-cycle assets
        if len(groups) + 8 > cls._SAMPLER_CAP:
            cls._SAMPLER_CAP = len(groups) + 8
        for items in groups.values():
            _, player0, _ = items[0]
            sampler = cls._sampler_for(player0.skeleton, player0.clip, device)
            palettes = sampler(np.asarray([t for _, _, t in items], np.float32))
            for (anim, player, _), pal in zip(items, palettes):
                pal = np.ascontiguousarray(pal)
                anim.bone_matrices = pal
                player._palette = pal

    @classmethod
    def _walk(cls, registry: Registry, dt: float, groups: dict) -> None:
        """update's host walk: advance each playing entity's time, pose
        the state-machine and clip-less ones, and group the clip-driven
        ones into `groups` by (skeleton, clip)."""
        for entity, (anim,) in registry.view(AnimationComponent):
            if not anim.playing:
                continue
            if anim.state_machine is not None:
                anim.bone_matrices = np.asarray(anim.state_machine.update(dt))
                anim.time += dt * anim.speed
                continue
            player = cls._player_for(entity, anim)
            if player is None:
                continue
            player.speed = anim.speed
            player.looping = anim.looping
            player.playing = True
            if player.clip is None:
                player.time = anim.time
                anim.bone_matrices = player.update(dt).copy()
                anim.time = player.time
                continue
            player.time = player._wrap(anim.time + dt * anim.speed)
            anim.time = player.time
            key = (id(player.skeleton), id(player.clip))
            groups.setdefault(key, []).append((anim, player, anim.time))

    @classmethod
    def update(cls, registry: Registry, dt: float, device=None) -> None:
        """Advance every playing AnimationComponent. Clip-driven entities
        are grouped by (skeleton, clip) and pose-sampled in ONE sampler
        call per group on `device` (anim/batch.py) — time advance / loop
        policy stays per-entity host state; only the state-machine path
        walks entities individually (reference: AnimationSystem.cpp:120-165
        is a per-entity loop for everything). The per-entity walk is the
        tracer's span `anim.walk` (utils/profiling.py)."""
        groups: Dict[tuple, list] = {}
        with TRACER.span("anim.walk"):
            cls._walk(registry, dt, groups)
        cls._sample_groups(groups, device)
        # players are keyed by entity id: prune entries whose entity no
        # longer carries an AnimationComponent so destroy/re-spawn cycles
        # don't pin skeletons and palettes forever
        if len(cls._players) > 4 * max(len(groups), 1) + 64:
            live = {e for e, _ in registry.view(AnimationComponent)}
            cls._players = {e: p for e, p in cls._players.items()
                            if e in live}
