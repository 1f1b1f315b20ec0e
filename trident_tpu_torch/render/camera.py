"""Cameras (port of trident_tpu/render/camera.py).

View/projection follow glm RH_ZO conventions with the Vulkan Y-flip;
matrices are rebuilt lazily on the host in numpy. `host_params()` hands
them over as numpy (the frame bundle packs them, render/bundle.py) and
`params(device)` as tensors on a device (the same values, uploaded).
EditorCamera: free camera with euler orientation or an explicit look-at,
and the orbit control (dolly and pan are not ported). RuntimeCamera:
driven by a scene CameraComponent and its entity's transform.
"""

from __future__ import annotations

import numpy as np

from trident_tpu_torch import resolve_device
from trident_tpu_torch.ecs.components import (
    CameraComponent,
    ProjectionType,
    TransformComponent,
)
from trident_tpu_torch.mathx.transforms import (
    euler_deg_to_mat3,
    look_at,
    ortho_rh_zo,
    perspective_rh_zo,
)
from trident_tpu_torch.render.types import CameraParams, from_numpy


class Camera:
    """Common camera state + matrix rebuild logic."""

    def __init__(self) -> None:
        self.position = np.zeros(3, dtype=np.float32)
        self.rotation = np.zeros(3, dtype=np.float32)  # euler degrees
        self.projection_type = ProjectionType.PERSPECTIVE
        self.fov_deg = 45.0
        self.ortho_size = 10.0
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

    def set_perspective(self, fov_deg: float, near: float, far: float) -> None:
        self.projection_type = ProjectionType.PERSPECTIVE
        self.fov_deg = float(np.clip(fov_deg, 1.0, 179.0))
        self.near_clip = max(near, 1e-3)
        self.far_clip = max(far, self.near_clip + 1e-3)
        self._dirty = True

    def set_orthographic(self, size: float, near: float, far: float) -> None:
        self.projection_type = ProjectionType.ORTHOGRAPHIC
        self.ortho_size = max(size, 0.01)
        self.near_clip = max(near, 1e-3)
        self.far_clip = max(far, self.near_clip + 1e-3)
        self._dirty = True

    def look_at_target(self, target, up=(0.0, 1.0, 0.0)) -> None:
        """Aim at `target` (kept as an explicit look-at; set_rotation
        clears it)."""
        target = np.asarray(target, np.float32)
        if np.linalg.norm(target - self.position) < 1e-8:
            return
        self._look_target = (target, np.asarray(up, np.float32))
        self._dirty = True

    def _rebuild(self) -> None:
        aspect = self.viewport[0] / max(self.viewport[1], 1)
        if self.projection_type == ProjectionType.PERSPECTIVE:
            self._proj = perspective_rh_zo(self.fov_deg, aspect,
                                           self.near_clip, self.far_clip)
        else:
            half_h = self.ortho_size * 0.5
            half_w = half_h * aspect
            self._proj = ortho_rh_zo(-half_w, half_w, -half_h, half_h,
                                     self.near_clip, self.far_clip)
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

    def host_params(self) -> CameraParams:
        """view, proj and position as f32 numpy arrays."""
        return CameraParams(view=np.asarray(self.view, np.float32),
                            proj=np.asarray(self.proj, np.float32),
                            position=np.asarray(self.position, np.float32))

    def params(self, device=None) -> CameraParams:
        """host_params() on `device` (the card unless given)."""
        return from_numpy(self.host_params(), resolve_device(device))


class EditorCamera(Camera):
    """Free camera with the orbit control (ApplicationLayer.h:104-138)."""

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


class RuntimeCamera(Camera):
    """Bound to the primary CameraComponent during play mode."""

    def bind(self, transform: TransformComponent,
             component: CameraComponent) -> None:
        self.set_position(transform.position)
        self.set_rotation(transform.rotation)
        if component.projection == ProjectionType.PERSPECTIVE:
            self.set_perspective(component.fov_deg, component.near_clip,
                                 component.far_clip)
        else:
            self.set_orthographic(component.ortho_size, component.near_clip,
                                  component.far_clip)
