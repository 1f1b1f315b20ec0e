"""Pose utilities: decomposed TRS poses, sampling, blending, compositing.

Reference: Animation/AnimationPose.{h,cpp} — SampleClipPose, BlendPose
(lerp/slerp with per-bone weight masks), AdditivePose, and
ComposeSkinningMatrices (hierarchy walk × inverse bind).

A pose is a dict of arrays {position (B,3), rotation (B,4) wxyz,
scale (B,3)} — vectorized over bones.

The port's own copy of trident_tpu/anim/pose.py (numpy; only the imports
differ): the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from trident_tpu_torch.anim.data import AnimationClip, Skeleton
from trident_tpu_torch.mathx.quat import quat_identity, quat_mul, quat_normalize, quat_slerp, quat_to_mat3


@dataclass
class Pose:
    position: np.ndarray    # (B,3)
    rotation: np.ndarray    # (B,4) wxyz
    scale: np.ndarray       # (B,3)

    @staticmethod
    def bind(skeleton: Skeleton) -> "Pose":
        b = len(skeleton)
        pos = np.zeros((b, 3), np.float32)
        rot = np.tile(np.asarray(quat_identity()), (b, 1)).astype(np.float32)
        scl = np.ones((b, 3), np.float32)
        for i, bone in enumerate(skeleton.bones):
            t, q, s = _decompose(bone.local_bind)
            pos[i], rot[i], scl[i] = t, q, s
        return Pose(pos, rot, scl)

    def copy(self) -> "Pose":
        return Pose(self.position.copy(), self.rotation.copy(), self.scale.copy())


def _decompose(m: np.ndarray):
    t = m[:3, 3].copy()
    scale = np.linalg.norm(m[:3, :3], axis=0)
    scale = np.where(scale < 1e-8, 1.0, scale).astype(np.float32)
    r3 = m[:3, :3] / scale[None, :]
    # rotation matrix → quaternion (wxyz), Shepperd's method
    tr = np.trace(r3)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (r3[2, 1] - r3[1, 2]) / s,
                      (r3[0, 2] - r3[2, 0]) / s, (r3[1, 0] - r3[0, 1]) / s])
    elif r3[0, 0] > r3[1, 1] and r3[0, 0] > r3[2, 2]:
        s = np.sqrt(1.0 + r3[0, 0] - r3[1, 1] - r3[2, 2]) * 2
        q = np.array([(r3[2, 1] - r3[1, 2]) / s, 0.25 * s,
                      (r3[0, 1] + r3[1, 0]) / s, (r3[0, 2] + r3[2, 0]) / s])
    elif r3[1, 1] > r3[2, 2]:
        s = np.sqrt(1.0 + r3[1, 1] - r3[0, 0] - r3[2, 2]) * 2
        q = np.array([(r3[0, 2] - r3[2, 0]) / s, (r3[0, 1] + r3[1, 0]) / s,
                      0.25 * s, (r3[1, 2] + r3[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + r3[2, 2] - r3[0, 0] - r3[1, 1]) * 2
        q = np.array([(r3[1, 0] - r3[0, 1]) / s, (r3[0, 2] + r3[2, 0]) / s,
                      (r3[1, 2] + r3[2, 1]) / s, 0.25 * s])
    return t.astype(np.float32), q.astype(np.float32), scale


def _sample_track(times: np.ndarray, values: np.ndarray, t: float,
                  is_quat: bool, default: np.ndarray) -> np.ndarray:
    k = len(times)
    if k == 0:
        return default
    if k == 1 or t <= times[0]:
        return values[0]
    if t >= times[-1]:
        return values[-1]
    hi = int(np.searchsorted(times, t, side="right"))
    lo = hi - 1
    span = float(times[hi] - times[lo])
    f = 0.0 if span <= 1e-9 else (t - float(times[lo])) / span
    if is_quat:
        return np.asarray(quat_slerp(values[lo], values[hi], np.float32(f)))
    return values[lo] * (1.0 - f) + values[hi] * f


def sample_clip_pose(clip: AnimationClip, skeleton: Skeleton, time: float,
                     base: Optional[Pose] = None) -> Pose:
    """Sample all channels at `time` (seconds, already wrapped) on top of the
    bind pose (bones without channels keep their bind transform)."""
    pose = (base or Pose.bind(skeleton)).copy()
    for bone_idx, ch in clip.channel_for(skeleton).items():
        pose.position[bone_idx] = _sample_track(
            ch.position_times, ch.positions, time, False, pose.position[bone_idx])
        pose.rotation[bone_idx] = _sample_track(
            ch.rotation_times, ch.rotations, time, True, pose.rotation[bone_idx])
        pose.scale[bone_idx] = _sample_track(
            ch.scale_times, ch.scales, time, False, pose.scale[bone_idx])
    return pose


def blend_pose(a: Pose, b: Pose, weight: float,
               mask: Optional[np.ndarray] = None) -> Pose:
    """lerp positions/scales, slerp rotations; `mask` (B,) scales the weight
    per bone (reference BlendPose semantics)."""
    w = np.full(a.position.shape[0], float(np.clip(weight, 0.0, 1.0)), np.float32)
    if mask is not None:
        w = w * np.asarray(mask, np.float32)
    w3 = w[:, None]
    rot = np.asarray(quat_slerp(a.rotation, b.rotation, w))
    return Pose(
        position=a.position * (1 - w3) + b.position * w3,
        rotation=rot.astype(np.float32),
        scale=a.scale * (1 - w3) + b.scale * w3,
    )


def additive_pose(base: Pose, additive: Pose, reference: Pose,
                  weight: float, mask: Optional[np.ndarray] = None) -> Pose:
    """base + weight * (additive - reference), quaternion delta composed."""
    w = np.full(base.position.shape[0], float(np.clip(weight, 0.0, 1.0)), np.float32)
    if mask is not None:
        w = w * np.asarray(mask, np.float32)
    w3 = w[:, None]
    delta_p = additive.position - reference.position
    delta_s = additive.scale - reference.scale
    # delta rotation = additive * reference^-1
    ref_inv = reference.rotation * np.array([1, -1, -1, -1], np.float32)
    delta_q = np.asarray(quat_mul(additive.rotation, ref_inv))
    ident = np.tile(np.asarray(quat_identity()), (base.position.shape[0], 1))
    delta_q = np.asarray(quat_slerp(ident.astype(np.float32), delta_q.astype(np.float32), w))
    return Pose(
        position=base.position + delta_p * w3,
        rotation=np.asarray(quat_mul(delta_q, base.rotation)).astype(np.float32),
        scale=base.scale + delta_s * w3,
    )


def local_matrices(pose: Pose) -> np.ndarray:
    """(B,4,4) local transforms from decomposed TRS."""
    b = pose.position.shape[0]
    rot3 = np.asarray(quat_to_mat3(quat_normalize(pose.rotation)))
    m = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    m[:, :3, :3] = rot3 * pose.scale[:, None, :]
    m[:, :3, 3] = pose.position
    return m


def compose_skinning_matrices(pose: Pose, skeleton: Skeleton) -> np.ndarray:
    """Hierarchy walk local→global, × inverse bind → (B,4,4) palette."""
    local = local_matrices(pose)
    b = len(skeleton)
    global_m = np.empty((b, 4, 4), np.float32)
    for i in skeleton.topo_order():
        parent = skeleton.bones[i].parent
        global_m[i] = local[i] if parent < 0 else global_m[parent] @ local[i]
    inv_bind = np.stack([bone.inverse_bind for bone in skeleton.bones])
    return np.einsum("bij,bjk->bik", global_m, inv_bind)
