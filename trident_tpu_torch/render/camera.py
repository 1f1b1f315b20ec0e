"""Editor camera (port of trident_tpu/render/camera.py).

View/projection follow glm RH_ZO conventions with the Vulkan Y-flip;
matrices are rebuilt lazily on the host in numpy and handed to the device
by `params(device)`. Of the editor controls only `orbit` is ported;
orthographic projection and the runtime camera are not part of the
ported slice.
"""

from __future__ import annotations

import numpy as np
import torch

from trident_tpu_torch import resolve_device
from trident_tpu_torch.mathx.transforms import (
    euler_deg_to_mat3,
    look_at,
    perspective_rh_zo,
)
from trident_tpu_torch.render.types import CameraParams


class EditorCamera:
    """Free perspective camera: euler orientation or an explicit look-at."""

    def __init__(self) -> None:
        self.position = np.zeros(3, dtype=np.float32)
        self.rotation = np.zeros(3, dtype=np.float32)  # euler degrees
        self.fov_deg = 45.0
        self.near_clip = 0.1
        self.far_clip = 1000.0
        self.viewport = (1920, 1080)
        self._look_target = None
        self._view = np.eye(4, dtype=np.float32)
        self._proj = np.eye(4, dtype=np.float32)
        self._dirty = True

    def set_position(self, position) -> None:
        self.position = np.asarray(position, dtype=np.float32)
        self._dirty = True

    def set_rotation(self, euler_deg) -> None:
        self.rotation = np.asarray(euler_deg, dtype=np.float32)
        self._look_target = None
        self._dirty = True

    def set_viewport_size(self, width: int, height: int) -> None:
        if (width, height) != self.viewport and width > 0 and height > 0:
            self.viewport = (width, height)
            self._dirty = True

    def look_at_target(self, target, up=(0.0, 1.0, 0.0)) -> None:
        """Aim at `target` (kept as an explicit look-at; set_rotation
        clears it)."""
        target = np.asarray(target, np.float32)
        if np.linalg.norm(target - self.position) < 1e-8:
            return
        self._look_target = (target, np.asarray(up, np.float32))
        self._dirty = True

    def orbit(self, pivot, d_yaw_deg: float, d_pitch_deg: float) -> None:
        """Turn the camera about `pivot` by yaw and pitch (degrees, pitch
        held within ±89°) at a fixed radius, then aim at the pivot."""
        pivot = np.asarray(pivot, np.float32)
        offset = self.position - pivot
        radius = np.linalg.norm(offset)
        if radius < 1e-6:
            return
        yaw = np.degrees(np.arctan2(offset[0], offset[2])) + d_yaw_deg
        pitch = np.degrees(np.arcsin(np.clip(offset[1] / radius, -1.0, 1.0))) \
            + d_pitch_deg
        pitch = np.clip(pitch, -89.0, 89.0)
        yr, pr = np.radians(yaw), np.radians(pitch)
        offset = radius * np.array(
            [np.cos(pr) * np.sin(yr), np.sin(pr), np.cos(pr) * np.cos(yr)],
            np.float32)
        self.set_position(pivot + offset)
        self.look_at_target(pivot)

    def _rebuild(self) -> None:
        aspect = self.viewport[0] / max(self.viewport[1], 1)
        self._proj = perspective_rh_zo(self.fov_deg, aspect, self.near_clip,
                                       self.far_clip)
        if self._look_target is not None:
            target, up = self._look_target
            self._view = look_at(self.position, target, up)
        else:
            rot = euler_deg_to_mat3(self.rotation)
            forward = rot @ np.array([0.0, 0.0, -1.0], np.float32)
            up = rot @ np.array([0.0, 1.0, 0.0], np.float32)
            self._view = look_at(self.position, self.position + forward, up)
        self._dirty = False

    @property
    def view(self) -> np.ndarray:
        if self._dirty:
            self._rebuild()
        return self._view

    @property
    def proj(self) -> np.ndarray:
        if self._dirty:
            self._rebuild()
        return self._proj

    def params(self, device=None) -> CameraParams:
        dev = resolve_device(device)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        return CameraParams(view=t(self.view), proj=t(self.proj),
                            position=t(self.position))
