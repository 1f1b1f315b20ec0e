"""Camera and model matrices of the reference (glm's right-handed
conventions, depth in [0, 1], Vulkan's y flip), in float64 numpy, handed
on as float32 tensors. Column vectors: clip = P · V · M · p."""

from __future__ import annotations

import numpy as np
import torch


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """View matrix of an eye at `eye` looking at `target` (lookAtRH)."""
    eye, target, up = (np.asarray(a, np.float64) for a in (eye, target, up))
    f = target - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def perspective(fov_y_deg: float, aspect: float, near: float,
                far: float) -> np.ndarray:
    """perspectiveRH_ZO with y flipped (Vulkan's framebuffer rows run
    down)."""
    t = np.tan(np.radians(fov_y_deg) / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = -1.0 / t
    m[2, 2] = far / (near - far)
    m[2, 3] = -(far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def trs(position, euler_deg, scale) -> np.ndarray:
    """(N, 4, 4) model matrices T · Rx · Ry · Rz · S of N entities (Euler
    angles in degrees)."""
    p = np.asarray(position, np.float64).reshape(-1, 3)
    e = np.radians(np.asarray(euler_deg, np.float64).reshape(-1, 3))
    s = np.asarray(scale, np.float64).reshape(-1, 3)
    n = max(p.shape[0], e.shape[0], s.shape[0])
    p, e, s = (np.broadcast_to(a, (n, 3)) for a in (p, e, s))
    cx, sx = np.cos(e[:, 0]), np.sin(e[:, 0])
    cy, sy = np.cos(e[:, 1]), np.sin(e[:, 1])
    cz, sz = np.cos(e[:, 2]), np.sin(e[:, 2])
    one, zero = np.ones(n), np.zeros(n)
    rx = np.stack([np.stack([one, zero, zero], -1),
                   np.stack([zero, cx, -sx], -1),
                   np.stack([zero, sx, cx], -1)], -2)
    ry = np.stack([np.stack([cy, zero, sy], -1),
                   np.stack([zero, one, zero], -1),
                   np.stack([-sy, zero, cy], -1)], -2)
    rz = np.stack([np.stack([cz, -sz, zero], -1),
                   np.stack([sz, cz, zero], -1),
                   np.stack([zero, zero, one], -1)], -2)
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3] = rx @ ry @ rz * s[:, None, :]
    m[:, :3, 3] = p
    return m


def camera(cam: dict, width: int, height: int, device):
    """(projection, view) as (4, 4) f32 tensors on `device` and the eye
    position of a configuration's camera (position, target, fov_deg,
    near, far)."""
    view = look_at(cam["position"], cam["target"])
    proj = perspective(cam["fov_deg"], width / height, cam["near"],
                       cam["far"])
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(proj, **f32), torch.tensor(view, **f32),
            tuple(float(x) for x in cam["position"]))
