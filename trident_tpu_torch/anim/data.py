"""Animation data model.

Reference: Animation/AnimationData.h — VectorKeyframe/QuaternionKeyframe/
TransformChannel/AnimationClip (times in seconds), Bone{name, source name,
parent, local bind, inverse bind}, Skeleton with name + source-name lookup.

Channels store keyframes as numpy arrays (times (K,), values (K,3|4)) —
vectorized host sampling, and packed into padded device tables by the
batched sampler (anim/batch.py).

The port's own copy of trident_tpu/anim/data.py (numpy; only the imports
differ): the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Bone:
    name: str
    source_name: str
    parent: int = -1                    # index into Skeleton.bones, -1 = root
    local_bind: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    inverse_bind: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    children: List[int] = field(default_factory=list)


MIXAMO_PREFIX = "mixamorig:"


def normalize_bone_name(name: str) -> str:
    """Strip the Mixamo namespace prefix (ModelLoader.cpp:56-79 semantics)."""
    low = name.lower()
    if low.startswith(MIXAMO_PREFIX):
        return name[len(MIXAMO_PREFIX):]
    return name


@dataclass
class Skeleton:
    name: str = ""
    bones: List[Bone] = field(default_factory=list)
    by_name: Dict[str, int] = field(default_factory=dict)
    by_source_name: Dict[str, int] = field(default_factory=dict)

    def add_bone(self, bone: Bone) -> int:
        index = len(self.bones)
        self.bones.append(bone)
        self.by_name[bone.name] = index
        self.by_source_name[bone.source_name] = index
        if bone.parent >= 0:
            self.bones[bone.parent].children.append(index)
        return index

    def find(self, name: str) -> int:
        """Resolve by normalized name, then source name (AnimationRemap.h)."""
        idx = self.by_name.get(normalize_bone_name(name), -1)
        if idx < 0:
            idx = self.by_source_name.get(name, -1)
        return idx

    def __len__(self) -> int:
        return len(self.bones)

    def topo_order(self) -> List[int]:
        """Parent-before-child traversal order."""
        order: List[int] = []
        stack = [i for i, b in enumerate(self.bones) if b.parent < 0]
        while stack:
            i = stack.pop(0)
            order.append(i)
            stack.extend(self.bones[i].children)
        return order


@dataclass
class TransformChannel:
    bone_name: str                       # source channel name (pre-normalization)
    position_times: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    rotation_times: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    rotations: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))  # wxyz
    scale_times: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    scales: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))


@dataclass
class AnimationClip:
    name: str
    duration: float                      # seconds
    channels: List[TransformChannel] = field(default_factory=list)

    def channel_for(self, skeleton: Skeleton) -> Dict[int, TransformChannel]:
        """Map bone index → channel using normalized/source names."""
        out: Dict[int, TransformChannel] = {}
        for ch in self.channels:
            idx = skeleton.find(ch.bone_name)
            if idx >= 0:
                out[idx] = ch
        return out
