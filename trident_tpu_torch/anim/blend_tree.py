"""Blend-tree nodes: ClipNode, BlendNode, BlendSpace1DNode.

Reference: Animation/AnimationBlendTree.{h,cpp} — ClipNode (loop/speed,
optional parameter-driven speed), BlendNode (two children, weight from a
parameter), BlendSpace1DNode (sample list keyed on a float parameter).
Nodes evaluate to a Pose; the state machine composes them.

The port's own copy of trident_tpu/anim/blend_tree.py (numpy; only the imports
differ): the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from trident_tpu_torch.anim.data import AnimationClip, Skeleton
from trident_tpu_torch.anim.pose import Pose, blend_pose, sample_clip_pose


@dataclass
class EvalContext:
    skeleton: Skeleton
    parameters: Dict[str, float]
    bind: Pose


class BlendNode:
    """Base node."""

    def evaluate(self, ctx: EvalContext, dt: float) -> Pose:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def copy(self) -> "BlendNode":
        raise NotImplementedError


class ClipNode(BlendNode):
    def __init__(self, clip: AnimationClip, looping: bool = True,
                 speed: float = 1.0, speed_parameter: Optional[str] = None):
        self.clip = clip
        self.looping = looping
        self.speed = speed
        self.speed_parameter = speed_parameter
        self.time = 0.0

    def reset(self) -> None:
        self.time = 0.0

    def evaluate(self, ctx: EvalContext, dt: float) -> Pose:
        speed = self.speed
        if self.speed_parameter is not None:
            speed *= ctx.parameters.get(self.speed_parameter, 1.0)
        self.time += dt * speed
        d = max(self.clip.duration, 1e-6)
        t = float(np.mod(self.time, d)) if self.looping else float(np.clip(self.time, 0, d))
        return sample_clip_pose(self.clip, ctx.skeleton, t, base=ctx.bind)

    def copy(self) -> "ClipNode":
        n = ClipNode(self.clip, self.looping, self.speed, self.speed_parameter)
        n.time = self.time
        return n


class Blend2Node(BlendNode):
    """Two children blended by a parameter (reference BlendNode)."""

    def __init__(self, a: BlendNode, b: BlendNode, weight_parameter: str,
                 mask: Optional[np.ndarray] = None):
        self.a = a
        self.b = b
        self.weight_parameter = weight_parameter
        self.mask = mask

    def reset(self) -> None:
        self.a.reset()
        self.b.reset()

    def evaluate(self, ctx: EvalContext, dt: float) -> Pose:
        w = float(np.clip(ctx.parameters.get(self.weight_parameter, 0.0), 0.0, 1.0))
        return blend_pose(self.a.evaluate(ctx, dt), self.b.evaluate(ctx, dt),
                          w, self.mask)

    def copy(self) -> "Blend2Node":
        return Blend2Node(self.a.copy(), self.b.copy(), self.weight_parameter, self.mask)


@dataclass
class BlendSample:
    value: float
    node: BlendNode


class BlendSpace1DNode(BlendNode):
    """N samples along one parameter axis; blends the bracketing pair."""

    def __init__(self, parameter: str, samples: List[BlendSample]):
        self.parameter = parameter
        self.samples = sorted(samples, key=lambda s: s.value)

    def reset(self) -> None:
        for s in self.samples:
            s.node.reset()

    def evaluate(self, ctx: EvalContext, dt: float) -> Pose:
        if not self.samples:
            return ctx.bind.copy()
        v = ctx.parameters.get(self.parameter, 0.0)
        # advance every child so their clocks stay coherent
        poses = [s.node.evaluate(ctx, dt) for s in self.samples]
        values = [s.value for s in self.samples]
        if v <= values[0]:
            return poses[0]
        if v >= values[-1]:
            return poses[-1]
        hi = int(np.searchsorted(values, v, side="right"))
        lo = hi - 1
        span = values[hi] - values[lo]
        f = 0.0 if span <= 1e-9 else (v - values[lo]) / span
        return blend_pose(poses[lo], poses[hi], f)

    def copy(self) -> "BlendSpace1DNode":
        return BlendSpace1DNode(
            self.parameter, [BlendSample(s.value, s.node.copy()) for s in self.samples])
