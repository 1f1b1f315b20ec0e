"""The editor camera's dolly, pan and frame_entity on trident_tpu_torch
against the JAX package's (trident_tpu/render/camera.py:154-177), on the
CPU: positions and view matrices within 1e-6 after each control, from an
euler and a look-at pose."""

import numpy as np
import pytest

from trident_tpu.ecs.components import TransformComponent as JTransform
from trident_tpu.ecs.registry import Registry as JRegistry
from trident_tpu.render.camera import EditorCamera as JEditorCamera
from trident_tpu.render.camera import frame_entity as jframe_entity

from trident_tpu_torch.ecs.components import TransformComponent
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.render.camera import EditorCamera, frame_entity

TOL = 1e-6


def _pair(look_at: bool):
    cams = []
    for cls in (JEditorCamera, EditorCamera):
        cam = cls()
        cam.set_viewport_size(64, 48)
        cam.set_position([1.5, 0.8, 4.0])
        if look_at:
            cam.look_at_target([0.2, -0.1, 0.0])
        else:
            cam.set_rotation([-12.0, 25.0, 0.0])
        cams.append(cam)
    return cams


def _same(j, p):
    np.testing.assert_allclose(p.position, j.position, rtol=0, atol=TOL)
    np.testing.assert_allclose(p.view, j.view, rtol=0, atol=TOL)


@pytest.mark.parametrize("look_at", [False, True], ids=["euler", "look_at"])
def test_dolly_and_pan_match_jax(look_at):
    j, p = _pair(look_at)
    for amount in (0.7, -1.3):
        j.dolly(amount)
        p.dolly(amount)
        _same(j, p)
    for dx, dy in ((0.4, -0.2), (-1.0, 0.5)):
        j.pan(dx, dy)
        p.pan(dx, dy)
        _same(j, p)
    j.orbit([0, 0, 0], 10.0, -5.0)
    p.orbit([0, 0, 0], 10.0, -5.0)
    j.dolly(0.25)
    p.dolly(0.25)
    _same(j, p)


@pytest.mark.parametrize("look_at", [False, True], ids=["euler", "look_at"])
def test_frame_entity_matches_jax(look_at):
    j, p = _pair(look_at)
    jreg, preg = JRegistry(), Registry()
    targets = []
    for pos, scale in (([2.0, 1.0, -3.0], [0.2, 0.3, 0.1]),
                       ([1.5, 0.8, 4.0], [1.0, 2.5, 1.0])):
        je, pe = jreg.create(), preg.create()
        jreg.add(je, JTransform(position=np.array(pos, np.float32),
                                scale=np.array(scale, np.float32)))
        preg.add(pe, TransformComponent(position=np.array(pos, np.float32),
                                        scale=np.array(scale, np.float32)))
        targets.append((je, pe))
    for je, pe in targets:          # the second sits on the camera
        for factor in (3.0, 1.5):
            jframe_entity(j, jreg, je, factor)
            frame_entity(p, preg, pe, factor)
            _same(j, p)
    # an entity without a transform leaves the camera where it is
    je, pe = jreg.create(), preg.create()
    before = p.position.copy()
    jframe_entity(j, jreg, je)
    frame_entity(p, preg, pe)
    np.testing.assert_array_equal(p.position, before)
    _same(j, p)
