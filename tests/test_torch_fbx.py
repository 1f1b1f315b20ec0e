"""The port's FBX loader (trident_tpu_torch/assets/fbx_loader.py) against
the JAX package's, on the CPU.

Each file is written once and loaded by both packages' load_model; every
ModelData field must be bit-equal (model_bit_equal): the meshes' arrays
(positions, normals, tangents, bitangents, UVs, indices in their Morton
order, skin indices and weights), materials, textures, instance
transforms, the skeleton (bones, parents, binds, inverse binds) and the
clips (times, T/R/S keys, durations). The files: tests/test_fbx.py's
binary and ASCII fixtures (static cube, two-bone skin and clip, instanced
geometry, a pivoted bone, MSVC 1.#INF literals, a truncated UV index, a
non-bone track), written by that module's own writers, and the port's
tube (tools_dev/scenes.py::write_tube_fbx), whose vertex colours only the
port reads. Garbage is rejected by both. A 128² skinned frame of the
two-bone fixture, imported and played through each package's Scene on the
reference raster, is held against the JAX frame under the golden gate.
"""

import unittest.mock as mock

import numpy as np
import pytest
import torch

import test_fbx
from trident_tpu.assets.model_loader import load_model as j_load_model
from trident_tpu_torch.assets.model_loader import load_model
from trident_tpu_torch.tools_dev import scenes

from test_torch_anim import reset_animation_state
from test_torch_frame import _assert_golden_gate

torch.set_num_threads(1)

MESH_FIELDS = ("positions", "normals", "tangents", "bitangents", "uvs",
               "indices", "bone_indices", "bone_weights")
TUBE = dict(bones=4, keys=6, segments=8, rings=6)


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_animation_state()
    yield
    reset_animation_state()


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


def model_bit_equal(data, jdata, port_colors=None):
    """Every field of the port's ModelData equals the JAX package's bit for
    bit. Vertex colours too, unless `port_colors` (one (V, 3) array per
    mesh) are given: the file carries colours, which the port reads and the
    JAX loaders leave white."""
    assert len(data.meshes) == len(jdata.meshes)
    for k, (m, jm) in enumerate(zip(data.meshes, jdata.meshes)):
        for f in MESH_FIELDS:
            _same(getattr(m, f), getattr(jm, f), f"mesh {k} {f}")
        if port_colors is None:
            _same(m.colors, jm.colors, f"mesh {k} colors")
        else:
            _same(m.colors, port_colors[k], f"mesh {k} port colors")
            assert (jm.colors == 1.0).all()
        assert (m.material_index, m.name) == (jm.material_index, jm.name)
    assert [vars(m) for m in data.materials] == \
        [vars(m) for m in jdata.materials]
    assert len(data.textures) == len(jdata.textures)
    for t, jt in zip(data.textures, jdata.textures):
        assert (t.path, t.name) == (jt.path, jt.name)
        _same(t.rgba, jt.rgba, f"texture {t.path}")
    assert len(data.instance_transforms) == len(jdata.instance_transforms)
    for x, jx in zip(data.instance_transforms, jdata.instance_transforms):
        _same(x, jx, "instance transform")
    assert (data.skeleton is None) == (jdata.skeleton is None)
    if data.skeleton is not None:
        sk, jsk = data.skeleton, jdata.skeleton
        assert (sk.name, sk.by_name, sk.by_source_name) == \
            (jsk.name, jsk.by_name, jsk.by_source_name)
        assert len(sk.bones) == len(jsk.bones)
        for b, jb in zip(sk.bones, jsk.bones):
            for f, v in vars(b).items():
                _same(v, getattr(jb, f), f"bone {b.name} {f}")
    assert len(data.clips) == len(jdata.clips)
    for c, jc in zip(data.clips, jdata.clips):
        assert (c.name, c.duration) == (jc.name, jc.duration)
        assert len(c.channels) == len(jc.channels)
        for ch, jch in zip(c.channels, jc.channels):
            for f, v in vars(ch).items():
                _same(v, getattr(jch, f), f"{c.name} {ch.bone_name} {f}")


# -- the fixtures of tests/test_fbx.py, each through its own writers --------

def _ascii(fixture):
    def write(path):
        with mock.patch("test_fbx.write_fbx", test_fbx.write_fbx_ascii):
            fixture(path)
    return write


def _instanced(path):
    o, p = test_fbx._obj_name, test_fbx._p
    test_fbx.write_fbx(path, [
        ("Objects", [], [
            test_fbx._geometry_node(100),
            ("Model", [200, o("treeA", "Model"), "Mesh"], [
                ("Properties70", [], [
                    p("Lcl Translation", "Lcl Translation", 2.0, 0.0, 0.0)])]),
            ("Model", [201, o("treeB", "Model"), "Mesh"], [
                ("Properties70", [], [
                    p("Lcl Translation", "Lcl Translation", -5.0, 0.0, 0.0)])]),
        ]),
        ("Connections", [], [
            ("C", ["OO", 200, 0], []), ("C", ["OO", 201, 0], []),
            ("C", ["OO", 100, 200], []), ("C", ["OO", 100, 201], []),
        ]),
    ])


def _pivoted(path):
    """test_fbx_pivoted_bone_animation_bakes_full_chain's file: the animated
    bone with a RotationPivot and a Z rotation 0 → 90°."""
    nodes = test_fbx._capture_nodes(test_fbx._write_skinned_two_bone, path)
    for node in nodes[0][2]:
        if node[0] == "Model" and node[1][0] == 401:
            props = node[2][0][2]
            props[:] = [q for q in props if q[1][0] != "PreRotation"]
            props.append(test_fbx._p("RotationPivot", "Vector3D", 0.0, 1.0,
                                     0.0))
        if node[0] == "AnimationCurve" and node[1][0] == 603:
            node[2][1] = ("KeyValueFloat",
                          [np.asarray([0.0, 45.0, 90.0], np.float32)], [])
    conns = nodes[1][2]
    for i, c in enumerate(conns):
        if c[1][:3] == ["OP", 602, 401]:
            conns[i] = ("C", ["OP", 602, 401, "Lcl Rotation"], [])
    test_fbx.write_fbx(path, nodes)


def _non_bone_track(path):
    """test_fbx_clip_duration_ignores_non_bone_tracks' file: a 10 s track
    on the mesh model beside the 1 s skeletal clip."""
    nodes = test_fbx._capture_nodes(test_fbx._write_skinned_two_bone, path)
    o = test_fbx._obj_name
    ktime10 = (np.array([0.0, 10.0]) * 46186158000).astype(np.int64)
    nodes[0][2].extend([
        ("AnimationCurveNode", [702, o("T", "AnimCurveNode"), ""], []),
        ("AnimationCurve", [703, o("", "AnimCurve"), ""], [
            ("KeyTime", [ktime10], []),
            ("KeyValueFloat", [np.asarray([0.0, 4.0], np.float32)], [])]),
    ])
    nodes[1][2].extend([("C", ["OO", 702, 601], []),
                        ("C", ["OP", 702, 200, "Lcl Translation"], []),
                        ("C", ["OP", 703, 702, "d|X"], [])])
    test_fbx.write_fbx(path, nodes)


def _msvc_inf(path):
    """test_fbx_ascii_msvc_inf_literals' file: the ASCII cube with its first
    coordinate written as 1.#INF."""
    _ascii(test_fbx._write_static_cube)(path)
    verts = test_fbx._quad_cube()[0]
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace(str(float(verts[0])), "1.#INF", 1))


def _truncated_uvs(path):
    """test_fbx_truncated_uv_index_degrades' file: a UVIndex of 5 entries."""
    nodes = test_fbx._capture_nodes(test_fbx._write_static_cube, path)
    for layer in nodes[0][2][0][2]:
        if layer[0] == "LayerElementUV":
            for i, sub in enumerate(layer[2]):
                if sub[0] == "UVIndex":
                    layer[2][i] = ("UVIndex", [sub[1][0][:5]], [])
    test_fbx.write_fbx(path, nodes)


FIXTURES = {
    "static_binary": test_fbx._write_static_cube,
    "static_ascii": _ascii(test_fbx._write_static_cube),
    "skinned_binary": test_fbx._write_skinned_two_bone,
    "skinned_ascii": _ascii(test_fbx._write_skinned_two_bone),
    "skinned_no_anim": lambda p: test_fbx._write_skinned_two_bone(
        p, with_anim=False),
    "instanced": _instanced,
    "pivoted_bone": _pivoted,
    "non_bone_track": _non_bone_track,
    "msvc_inf_ascii": _msvc_inf,
    "truncated_uv_index": _truncated_uvs,
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fbx_fixture_matches_jax(name, tmp_path):
    path = str(tmp_path / f"{name}.fbx")
    FIXTURES[name](path)
    data, jdata = load_model(path), j_load_model(path)
    model_bit_equal(data, jdata)
    assert data.meshes
    if name == "msvc_inf_ascii":
        assert np.isfinite(data.meshes[0].positions).all()
    if name == "instanced":
        assert len(data.meshes) == 2


def test_tube_fbx_matches_jax_and_the_glb(tmp_path):
    """write_tube_fbx's tube: bit-equal to the JAX load but for the vertex
    colours, which are tube_mesh_arrays'; the mesh is the .glb's (the skin
    slots aside where a vertex's lower weight is 0, same products), and
    the clip poses the .glb's clip within 1e-6."""
    path = scenes.write_tube_fbx(tmp_path / "tube.fbx", **TUBE)
    data, jdata = load_model(path), j_load_model(path)
    arrs = scenes.tube_mesh_arrays(TUBE["segments"], TUBE["rings"],
                                   TUBE["bones"])
    model_bit_equal(data, jdata, port_colors=[arrs["colors"]])
    glb = load_model(scenes.write_tube_gltf(tmp_path / "tube.glb", **TUBE))
    m, g = data.meshes[0], glb.meshes[0]
    for f in ("positions", "normals", "tangents", "bitangents", "uvs",
              "colors", "indices"):
        _same(getattr(m, f), getattr(g, f), f"tube {f}")
    skin = (m.bone_weights[:, :, None] * (m.bone_indices[:, :, None]
                                          == np.arange(TUBE["bones"])))
    gskin = (g.bone_weights[:, :, None] * (g.bone_indices[:, :, None]
                                           == np.arange(TUBE["bones"])))
    _same(skin.sum(1), gskin.sum(1), "tube skin")
    for b, gb in zip(data.skeleton.bones, glb.skeleton.bones):
        _same(b.local_bind, gb.local_bind, "local bind")
        _same(b.inverse_bind, gb.inverse_bind, "inverse bind")
    from trident_tpu_torch.anim.player import AnimationPlayer

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


def test_fbx_garbage_rejected_by_both(tmp_path):
    path = str(tmp_path / "junk.fbx")
    with open(path, "wb") as f:
        f.write(b"\x89PNG not an fbx at all")
    for load in (load_model, j_load_model):
        with pytest.raises(Exception, match="FBX"):
            load(path)


def _skinned_frames(pkg: str, path: str) -> list:
    """test_fbx_renders_skinned's drive in one package: the file imported
    into a Scene, its clip played, frames after update(0.0) and
    update(1.0), 128² on the reference raster."""
    if pkg == "port":
        from trident_tpu_torch.assets.scene_loader import import_model_entities
        from trident_tpu_torch.core.config import EngineConfig, RenderConfig
        from trident_tpu_torch.ecs.components import AnimationComponent
        from trident_tpu_torch.ecs.scene import Scene
        from trident_tpu_torch.render.renderer import Renderer
        kw = dict(device="cpu")
    else:
        from trident_tpu.assets.scene_loader import import_model_entities
        from trident_tpu.core.config import EngineConfig, RenderConfig
        from trident_tpu.ecs.components import AnimationComponent
        from trident_tpu.ecs.scene import Scene
        from trident_tpu.render.renderer import Renderer
        kw = {}
    r = Renderer(EngineConfig(render=RenderConfig(
        width=128, height=128, use_pallas=False)), **kw)
    scene = Scene(renderer=r)
    r.set_active_registry(scene.editor_registry)
    ents = import_model_entities(path, scene.editor_registry, r)
    scene.editor_registry.add(ents[0], AnimationComponent(
        skeleton_asset=path, animation_asset=path, clip_index=0,
        playing=True, looping=False))
    r.editor_camera.set_position([0, 0, 9])
    r.editor_camera.look_at_target([0, 0, 0])
    scene.play()
    r.set_active_registry(scene.runtime_registry)
    frames = []
    for dt in (0.0, 1.0):
        scene.update(dt)
        frames.append(np.asarray(r.read_frame()))
    return frames


def test_fbx_skinned_frame_matches_jax(tmp_path):
    path = str(tmp_path / "arm.fbx")
    test_fbx._write_skinned_two_bone(path)
    port = _skinned_frames("port", path)
    reset_animation_state()
    jax = _skinned_frames("jax", path)
    for p, j in zip(port, jax):
        _assert_golden_gate(p, j)
    assert (port[0][..., :3] != port[1][..., :3]).any()    # the clip moved
