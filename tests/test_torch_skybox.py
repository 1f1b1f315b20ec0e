"""The skybox on the port: sample_skybox and _background against the JAX
package's functions, the level _skybox_for picks against the JAX
Renderer's, and the flavor_skybox scene's frame against the JAX frame.

sample_skybox is held on random directions and on the exact face
diagonals and edges, where the face choice is decided by `>=` against `>`
(x wins ties with y and z, y with z): the face and the texel are the same,
and the colours agree to 1e-6 (both packages evaluate the same
elementwise expressions in f32). _background's view ray is the port's own
three-term sum, the JAX package's a matrix product; it is held to 1e-5
per channel on all but a handful of pixels where the ray sits on a face
edge.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ops import deferred as jdeferred
from trident_tpu.ops import shading as jshading
from trident_tpu.render.types import CameraParams as JCameraParams
from trident_tpu.render.types import SkyboxCube as JSkyboxCube

from trident_tpu_torch.ops import deferred, shading
from trident_tpu_torch.render.types import SkyboxCube, from_numpy
from trident_tpu_torch.tools_dev.scenes import feature_scene, gradient_faces

from test_torch_frame import check_feature_frame, jax_feature_renderer

torch.set_num_threads(1)


def _faces(seed=3, edge=8):
    return np.random.default_rng(seed).uniform(
        0, 1, (6, edge, edge, 3)).astype(np.float32)


def _directions():
    rng = np.random.default_rng(11)
    d = rng.standard_normal((4000, 3)).astype(np.float32)
    # every face diagonal and edge: |x| = |y| = |z|, |x| = |y| > |z|, ...
    s = np.array([-1.0, 1.0], np.float32)
    diag = np.array([[a, b, c] for a in s for b in s for c in s])
    edges = []
    for a in s:
        for b in s:
            for c in (-0.5, 0.0, 0.5):
                edges += [[a, b, c], [a, c, b], [c, a, b]]
    return np.concatenate([d, diag, np.array(edges, np.float32),
                           np.eye(3, dtype=np.float32),
                           -np.eye(3, dtype=np.float32)])


@pytest.mark.parametrize("bilinear", [True, False], ids=["bilinear",
                                                         "nearest"])
def test_sample_skybox_matches_jax(bilinear):
    faces, dirs = _faces(), _directions()
    ref = np.asarray(jshading.sample_skybox(jnp.asarray(faces),
                                            jnp.asarray(dirs), bilinear))
    got = shading.sample_skybox(torch.from_numpy(faces),
                                torch.from_numpy(dirs), bilinear).numpy()
    assert got.shape == ref.shape == (dirs.shape[0], 3)
    assert np.abs(got - ref).max() <= 1e-6
    # the diagonals and edges (the ties) pick the same face's texel
    ties = slice(4000, None)
    assert np.abs(got[ties] - ref[ties]).max() <= 1e-6


def test_sample_skybox_face_ties_follow_the_reference():
    """+x wins a tie with y and z, +y a tie with z: a face whose texels are
    all one colour shows which face a tie picked."""
    faces = np.zeros((6, 4, 4, 3), np.float32)
    for f in range(6):
        faces[f] = f / 5.0
    dirs = np.array([[1, 1, 1], [-1, 1, 1], [0, 1, 1], [0, -1, -1],
                     [1, 0, -1], [0, 0, -1]], np.float32)
    got = shading.sample_skybox(torch.from_numpy(faces),
                                torch.from_numpy(dirs)).numpy()[:, 0] * 5
    assert np.round(got).astype(int).tolist() == [0, 1, 2, 3, 0, 5]


def _camera(seed):
    from trident_tpu.render.camera import EditorCamera

    cam = EditorCamera()
    rng = np.random.default_rng(seed)
    cam.set_position(rng.uniform(-3, 3, 3).tolist())
    cam.look_at_target([0, 0, 0])
    cam.set_viewport_size(96, 64)
    return cam.params()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_background_matches_jax(seed):
    faces = gradient_faces(16)
    jcam = _camera(seed)
    jsky = JSkyboxCube(faces=jnp.asarray(faces), valid=jnp.asarray(True))
    clear = (0.05, 0.05, 0.08, 1.0)
    with jax.disable_jit():
        ref = np.asarray(jdeferred._background(jcam, jsky, 96, 64, clear))
    cam = from_numpy(JCameraParams(*[np.asarray(a) for a in jcam]), "cpu")
    sky = SkyboxCube(torch.from_numpy(faces),
                     torch.ones((), dtype=torch.bool))
    got = deferred._background(cam, sky, 96, 64, clear, "cpu").numpy()
    assert got.shape == ref.shape == (64, 96, 3)
    off = np.abs(got - ref).max(axis=-1) > 1e-5
    assert off.sum() <= 5, off.sum()
    # without a skybox, or with valid False, it is the clear colour
    for s in (None, sky._replace(valid=torch.zeros((), dtype=torch.bool))):
        bg = deferred._background(cam, s, 96, 64, clear, "cpu")
        assert (bg == torch.tensor(clear[:3])).all()


@pytest.mark.parametrize("height", [64, 540, 1080])
def test_skybox_level_matches_jax(height):
    """_skybox_for picks the JAX Renderer's level of a 64² chain with a 32²
    and a 16² level for each viewport height (tests/test_skybox_app.py's
    pattern), and the level is the one on the device."""
    chain = [gradient_faces(64), gradient_faces(32), gradient_faces(16)]
    jr = jax_feature_renderer("skybox")
    jr.set_skybox(chain[0], mips=chain[1:])
    tr = feature_scene("skybox", "cpu")
    tr.set_skybox(chain[0], mips=chain[1:])
    for fov in (30.0, 60.0, 90.0):
        want = jr._skybox_for(height, fov)
        got = tr._skybox_for(height, fov)
        assert got.faces.shape == tuple(want.faces.shape)
        assert (got.faces.numpy() == np.asarray(want.faces)).all()
        assert bool(got.valid)
    assert tr._skybox_for(height, 60.0).faces.shape[1] in (64, 32, 16)


def test_set_skybox_keys_the_frame():
    """A new set_skybox is a new frame key and idle-frame signature; a
    viewport whose height picks another level keys another graph."""
    r = feature_scene("skybox", "cpu")
    a = r.frame_bundle()
    assert a.key[-2] == ((6, 16, 16, 3), 1)
    r.set_skybox(gradient_faces(16) * 0.5)
    b = r.frame_bundle()
    assert b.key != a.key and b.sig != a.sig
    assert (r.render_viewport().color != feature_scene(
        "skybox", "cpu").render_viewport().color).any()
    r.set_skybox(gradient_faces(64),
                 mips=[gradient_faces(32), gradient_faces(16)])
    tall = r.frame_bundle()
    assert tall.key[-2] == ((6, 64, 64, 3), 3)
    r.set_viewport(0, 128, 16)            # 16 rows: the 32² level suffices
    assert r.frame_bundle().key[-2] == ((6, 32, 32, 3), 3)


def test_skybox_frame_matches_jax(tmp_path):
    """The flavor_skybox scene (a 16² gradient cube map behind the `_base`
    scene) against the JAX frame; the sky is not the clear colour."""
    r, out, _j = check_feature_frame("skybox", tmp_path)
    sky = (out.tri_id < 0).numpy()
    clear = np.round(np.array(r.config.render.clear_color) * 255)
    assert sky.sum() > 1000
    assert (out.color.numpy()[sky] != clear).any(-1).mean() > 0.99
