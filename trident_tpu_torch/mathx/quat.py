"""Quaternion math (wxyz order, matching glm::quat) for animation sampling.

Port of trident_tpu/mathx/quat.py. Used by the clip sampler and pose
blending (reference: AnimationPlayer.cpp lerp/slerp key interpolation,
AnimationPose.cpp BlendPose). Batched over leading dimensions. Each
function computes with numpy on numpy arrays (the host pose code,
anim/pose.py) and with torch on torch tensors, on the tensors' device
(the batched sampler, anim/batch.py), in f32 either way, with the same
arithmetic as the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch


class _TorchNamespace:
    """The numpy names this module uses, on torch tensors."""

    float32 = torch.float32
    abs = torch.abs
    arccos = torch.arccos
    cos = torch.cos
    sin = torch.sin
    radians = torch.deg2rad
    where = torch.where
    zeros_like = torch.zeros_like

    @staticmethod
    def asarray(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype)

    @staticmethod
    def stack(arrays, axis=0):
        return torch.stack(arrays, dim=axis)

    @staticmethod
    def sum(a, axis=None, keepdims=False):
        return torch.sum(a, dim=axis, keepdim=keepdims)

    @staticmethod
    def clip(a, lo, hi):
        return torch.clamp(a, lo, hi)

    class linalg:
        @staticmethod
        def norm(a, axis=None, keepdims=False):
            return torch.linalg.vector_norm(a, dim=axis, keepdim=keepdims)


def _xp(*arrays):
    """torch when any argument is a torch tensor, else numpy."""
    if any(isinstance(a, torch.Tensor) for a in arrays):
        return _TorchNamespace
    return np


def quat_identity(xp=np):
    """(4,) f32 identity; pass xp=torch for a tensor."""
    return xp.asarray([1.0, 0.0, 0.0, 0.0], dtype=xp.float32)


def quat_normalize(q):
    xp = _xp(q)
    q = xp.asarray(q, dtype=xp.float32)
    n = xp.linalg.norm(q, axis=-1, keepdims=True)
    return q / xp.where(n < 1e-12, 1.0, n)


def quat_mul(a, b):
    xp = _xp(a, b)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return xp.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def quat_from_euler_deg(euler_deg):
    """Quaternion equal to Rx·Ry·Rz (the reference's compose order)."""
    xp = _xp(euler_deg)
    e = xp.radians(xp.asarray(euler_deg, dtype=xp.float32)) * 0.5
    cx, sx = xp.cos(e[..., 0]), xp.sin(e[..., 0])
    cy, sy = xp.cos(e[..., 1]), xp.sin(e[..., 1])
    cz, sz = xp.cos(e[..., 2]), xp.sin(e[..., 2])
    qx = xp.stack([cx, sx, xp.zeros_like(sx), xp.zeros_like(sx)], axis=-1)
    qy = xp.stack([cy, xp.zeros_like(sy), sy, xp.zeros_like(sy)], axis=-1)
    qz = xp.stack([cz, xp.zeros_like(sz), xp.zeros_like(sz), sz], axis=-1)
    return quat_mul(quat_mul(qx, qy), qz)


def quat_to_mat3(q):
    xp = _xp(q)
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        xp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
        xp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
        xp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
    ]
    return xp.stack(rows, axis=-2)


def quat_slerp(a, b, t):
    """Shortest-arc slerp with nlerp fallback for near-parallel quats.
    Branch-free (`where`s), so one call covers a whole batch."""
    xp = _xp(a, b)
    a = xp.asarray(a, dtype=xp.float32)
    b = xp.asarray(b, dtype=xp.float32)
    t = xp.asarray(t, dtype=xp.float32)
    dot = xp.sum(a * b, axis=-1, keepdims=True)
    b = xp.where(dot < 0.0, -b, b)
    dot = xp.abs(dot)
    dot_c = xp.clip(dot, -1.0, 1.0)
    theta = xp.arccos(xp.clip(dot_c, 0.0, 1.0))
    sin_theta = xp.sin(theta)
    safe = sin_theta > 1e-5
    sin_theta_safe = xp.where(safe, sin_theta, 1.0)
    t_e = t[..., None] if getattr(t, "ndim", 0) < a.ndim else t
    w_a = xp.where(safe, xp.sin((1.0 - t_e) * theta) / sin_theta_safe, 1.0 - t_e)
    w_b = xp.where(safe, xp.sin(t_e * theta) / sin_theta_safe, t_e)
    return quat_normalize(w_a * a + w_b * b)
