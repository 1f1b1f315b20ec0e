"""Host-side transform and camera math, numpy only.

Port of trident_tpu/mathx/transforms.py (its numpy branch; that module
imports jax whenever jax is installed, so the port keeps its own copy).
Conventions are the reference's glm ones:
  * model matrix = T · Rx · Ry · Rz · S, euler angles in DEGREES
  * projection = glm::perspectiveRH_ZO (depth in [0,1]) with the Vulkan
    Y-flip `proj[1][1] *= -1`; the light camera's glm::orthoRH_ZO likewise
  * view = glm::lookAtRH
Matrices are row-major arrays multiplying COLUMN vectors: clip = P@V@M@p.
"""

from __future__ import annotations

import numpy as np


def _trig(angle_rad):
    a = np.asarray(angle_rad, dtype=np.float32)
    c, s = np.cos(a), np.sin(a)
    return c, s, np.zeros_like(c), np.ones_like(c)


def _mat(rows) -> np.ndarray:
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def rotate_x(angle_rad) -> np.ndarray:
    c, s, z, o = _trig(angle_rad)
    return _mat([[o, z, z, z], [z, c, -s, z], [z, s, c, z], [z, z, z, o]])


def rotate_y(angle_rad) -> np.ndarray:
    c, s, z, o = _trig(angle_rad)
    return _mat([[c, z, s, z], [z, o, z, z], [-s, z, c, z], [z, z, z, o]])


def rotate_z(angle_rad) -> np.ndarray:
    c, s, z, o = _trig(angle_rad)
    return _mat([[c, -s, z, z], [s, c, z, z], [z, z, o, z], [z, z, z, o]])


def euler_deg_to_mat3(euler_deg) -> np.ndarray:
    """Rx·Ry·Rz rotation from degrees (the reference's compose order)."""
    e = np.radians(np.asarray(euler_deg, dtype=np.float32))
    r = rotate_x(e[..., 0]) @ rotate_y(e[..., 1]) @ rotate_z(e[..., 2])
    return r[..., :3, :3]


def compose_trs(translation, rotation_euler_deg, scale) -> np.ndarray:
    """T · Rx · Ry · Rz · S → (...,4,4) f32, batched over leading dims."""
    t = np.asarray(translation, dtype=np.float32)
    s = np.asarray(scale, dtype=np.float32)
    m3 = euler_deg_to_mat3(rotation_euler_deg) * s[..., None, :]
    m = np.array(np.broadcast_to(np.eye(4, dtype=np.float32),
                                 (*t.shape[:-1], 4, 4)))
    m[..., :3, :3] = m3
    m[..., :3, 3] = t
    return m


def look_at(eye, center, up) -> np.ndarray:
    """glm::lookAtRH."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = center - eye
    f = f / np.linalg.norm(f, axis=-1, keepdims=True)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s, axis=-1, keepdims=True)
    u = np.cross(s, f)
    row0 = np.concatenate([s, -np.sum(s * eye, axis=-1, keepdims=True)], -1)
    row1 = np.concatenate([u, -np.sum(u * eye, axis=-1, keepdims=True)], -1)
    row2 = np.concatenate([-f, np.sum(f * eye, axis=-1, keepdims=True)], -1)
    row3 = np.broadcast_to(np.asarray([0.0, 0.0, 0.0, 1.0], np.float32),
                           row0.shape)
    return np.stack([row0, row1, row2, row3], axis=-2)


def perspective_rh_zo(fov_y_deg, aspect, near, far,
                      flip_y: bool = True) -> np.ndarray:
    """glm::perspectiveRH_ZO (+ the Vulkan Y-flip by default)."""
    fov = np.radians(np.asarray(fov_y_deg, dtype=np.float32))
    tan_half = np.tan(fov / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = (-1.0 if flip_y else 1.0) / tan_half
    m[2, 2] = far / (near - far)
    m[2, 3] = -(far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def ortho_rh_zo(left, right, bottom, top, near, far,
                flip_y: bool = True) -> np.ndarray:
    """glm::orthoRH_ZO (+ the Vulkan Y-flip by default)."""
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom) * (-1.0 if flip_y else 1.0)
    m[2, 2] = -1.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -near / (far - near)
    m[3, 3] = 1.0
    return m


def normal_matrix(model) -> np.ndarray:
    """transpose(inverse(mat3(model))), batched."""
    return np.swapaxes(np.linalg.inv(np.asarray(model)[..., :3, :3]), -1, -2)
