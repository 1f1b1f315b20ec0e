"""The port's COLLADA loader (trident_tpu_torch/assets/dae_loader.py)
against the JAX package's, on the CPU.

The three documents of tests/test_dae.py (a Z_UP static quad with a
material, a skinned strip with an animation, single-axis rotate and
component translate channels) and the port's tube
(tools_dev/scenes.py::write_tube_dae) are each written once and loaded by
both packages' load_model; every ModelData field must be bit-equal
(test_torch_fbx.py::model_bit_equal), but the tube's vertex colours,
which only the port reads. The tube's mesh is the .glb's up to the order
of each vertex's influences (the COLLADA loader sorts them by weight) and
their renormalization, and its clip poses the .glb's clip within 1e-6. A
128² skinned frame of the strip, imported and played through each
package's Scene on the reference raster, is held against the JAX frame
under the golden gate.
"""

import numpy as np
import pytest
import torch

import test_dae
from trident_tpu.assets.model_loader import load_model as j_load_model
from trident_tpu_torch.anim.player import AnimationPlayer
from trident_tpu_torch.assets.model_loader import load_model
from trident_tpu_torch.tools_dev import scenes

from test_torch_anim import reset_animation_state
from test_torch_fbx import TUBE, _same, _skinned_frames, model_bit_equal
from test_torch_frame import _assert_golden_gate

torch.set_num_threads(1)

DOCUMENTS = {"static": test_dae._STATIC, "skinned": test_dae._SKINNED,
             "rotate_and_component": test_dae._ROTATE_ANIM}


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_animation_state()
    yield
    reset_animation_state()


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_dae_document_matches_jax(name, tmp_path):
    path = tmp_path / f"{name}.dae"
    path.write_text(DOCUMENTS[name])
    data, jdata = load_model(str(path)), j_load_model(str(path))
    model_bit_equal(data, jdata)
    # the third document is a clip alone
    assert len(data.meshes) == (name != "rotate_and_component")
    assert len(data.clips) == (name != "static")


def test_tube_dae_matches_jax_and_the_glb(tmp_path):
    path = scenes.write_tube_dae(tmp_path / "tube.dae", **TUBE)
    data, jdata = load_model(path), j_load_model(path)
    arrs = scenes.tube_mesh_arrays(TUBE["segments"], TUBE["rings"],
                                   TUBE["bones"])
    model_bit_equal(data, jdata, port_colors=[arrs["colors"]])
    glb = load_model(scenes.write_tube_gltf(tmp_path / "tube.glb", **TUBE))
    m, g = data.meshes[0], glb.meshes[0]
    for f in ("positions", "normals", "tangents", "bitangents", "uvs",
              "colors", "indices"):
        _same(getattr(m, f), getattr(g, f), f"tube {f}")
    onehot = np.arange(TUBE["bones"])
    np.testing.assert_allclose(
        (m.bone_weights[:, :, None] * (m.bone_indices[:, :, None] == onehot))
        .sum(1),
        (g.bone_weights[:, :, None] * (g.bone_indices[:, :, None] == onehot))
        .sum(1), atol=1e-7, rtol=0)
    for b, gb in zip(data.skeleton.bones, glb.skeleton.bones):
        assert b.parent == gb.parent
        _same(b.local_bind, gb.local_bind, "local bind")
        _same(b.inverse_bind, gb.inverse_bind, "inverse bind")
    players = []
    for d in (data, glb):
        p = AnimationPlayer(d.skeleton)
        p.set_clip(d.clips[0])
        players.append(p)
    assert data.clips[0].duration == glb.clips[0].duration
    for t in np.linspace(0.0, 2.0, 9):
        np.testing.assert_allclose(players[0].evaluate_at(float(t)),
                                   players[1].evaluate_at(float(t)),
                                   atol=1e-6, rtol=0)


def test_dae_garbage_rejected_by_both(tmp_path):
    path = tmp_path / "junk.dae"
    path.write_text("<COLLADA><library_geometries>")
    for load in (load_model, j_load_model):
        with pytest.raises(Exception):
            load(str(path))


def test_dae_skinned_frame_matches_jax(tmp_path):
    path = tmp_path / "strip.dae"
    path.write_text(test_dae._SKINNED)
    port = _skinned_frames("port", str(path))
    reset_animation_state()
    jax = _skinned_frames("jax", str(path))
    for p, j in zip(port, jax):
        _assert_golden_gate(p, j)
    assert (port[0][..., :3] != port[1][..., :3]).any()    # the clip moved
