"""The port's model import (trident_tpu_torch/assets, io/image.py's PNG
decoder) against the JAX package's, on the CPU.

load_model of both packages on the same files: the glTF rig of
tests/test_assets.py::make_skinned_gltf, a GLB with an embedded PNG, a
glTF with a data-URI PNG and one with a file texture, OBJ + MTL with
negative indices, ASCII and binary STL, ASCII and binary PLY, and the
port's own tube .glb (tools_dev/scenes.py::write_tube_gltf). Every Mesh
array is exact but normals, tangents and bitangents (atol 1e-6); the
materials, skeleton (bones, parents, binds, inverse binds), clips
(channels, times, values, durations), textures (paths, decoded pixels)
and instance transforms are equal. The JAX OBJ path is its Python parser
(prefer_native=False); the port's default OBJ path is its native loader,
whose ModelData is its Python parser's (tests/test_torch_native_loader.py).
.fbx and .dae load (tests/test_torch_{fbx,dae}.py hold them against the
JAX loaders); garbage in those formats raises a clean exception, and the
directory import logs and skips it.

The JAX package decodes images with PIL; the port's decoder is its own
(PNG only) and must give PIL's pixels on every PNG colour type it reads.
"""

import base64
import io
import json
import logging
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from trident_tpu.anim.player import AnimationPlayer as JPlayer
from trident_tpu.anim.service import AnimationAssetService as JService
from trident_tpu.assets import model_loader as jml
from trident_tpu.assets.scene_loader import (
    import_model_entities as j_import,
    load_scene_directory as j_load_dir,
)
from trident_tpu.core.config import EngineConfig as JEngineConfig
from trident_tpu.core.config import RenderConfig as JRenderConfig
from trident_tpu.ecs import components as jc
from trident_tpu.ecs.registry import Registry as JRegistry
from trident_tpu.render.renderer import Renderer as JRenderer

from trident_tpu_torch.anim.service import AnimationAssetService
from trident_tpu_torch.assets import model_loader as pml
from trident_tpu_torch.assets.scene_loader import (
    import_model_entities,
    load_scene_directory,
)
from trident_tpu_torch.core.config import EngineConfig, RenderConfig
from trident_tpu_torch.ecs import components as pc
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.io import image as pimage
from trident_tpu_torch.render.renderer import Renderer
from trident_tpu_torch.tools_dev import scenes

from test_assets import make_skinned_gltf, write_obj
from test_stl_ply import QUAD, _write_binary_stl
from test_torch_anim import reset_animation_state

torch.set_num_threads(1)

NORMAL_TOL = 1e-6
EXACT = ("positions", "indices", "colors", "uvs", "bone_indices",
         "bone_weights")
DERIVED = ("normals", "tangents", "bitangents")


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_animation_state()
    yield
    reset_animation_state()


# -- files ----------------------------------------------------------------------

def _png_bytes(img: np.ndarray, mode=None) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG")
    return buf.getvalue()


def _textured_doc(image: dict, uri_buffer: str = None):
    """A one-triangle textured glTF document with `image` as its only
    image, and its buffer blob (positions, uvs, indices)."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uvs = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    indices = np.array([0, 1, 2], np.uint16)
    blob = positions.tobytes() + uvs.tobytes() + indices.tobytes()
    buffer = {"byteLength": len(blob)}
    if uri_buffer:
        buffer["uri"] = uri_buffer + base64.b64encode(blob).decode()
    doc = {
        "asset": {"version": "2.0"},
        "nodes": [{"mesh": 0, "translation": [0.5, 0, -1],
                   "rotation": [0, 0.3826834, 0, 0.9238795],
                   "scale": [2, 2, 2]}],
        "meshes": [{"name": "tri", "primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
            "indices": 2, "material": 0}]}],
        "materials": [{"name": "tex", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
            "metallicFactor": 0.25, "roughnessFactor": 0.5}}],
        "textures": [{"source": 0}],
        "images": [image],
        "buffers": [buffer],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 24},
            {"buffer": 0, "byteOffset": 60, "byteLength": 6},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 3, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 3, "type": "SCALAR"},
        ],
    }
    return doc, blob


def _seeded_image(seed=4, shape=(8, 12, 4)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def write_glb_embedded(tmp_path) -> str:
    """A GLB whose image is a PNG in a bufferView of its BIN chunk."""
    png = _png_bytes(_seeded_image())
    doc, blob = _textured_doc({"bufferView": 3, "mimeType": "image/png"})
    pad = b"\0" * (-len(blob) % 4)
    doc["bufferViews"].append({"buffer": 0, "byteOffset": len(blob) + len(pad),
                               "byteLength": len(png)})
    blob = blob + pad + png
    blob += b"\0" * (-len(blob) % 4)
    doc["buffers"][0]["byteLength"] = len(blob)
    text = json.dumps(doc).encode()
    text += b" " * (-len(text) % 4)
    path = tmp_path / "embedded.glb"
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, 28 + len(text) + len(blob))
                     + struct.pack("<II", len(text), 0x4E4F534A) + text
                     + struct.pack("<II", len(blob), 0x004E4942) + blob)
    return str(path)


def write_gltf_data_uri(tmp_path) -> str:
    png = _png_bytes(_seeded_image(5, (6, 6, 3)))
    doc, _ = _textured_doc(
        {"uri": "data:image/png;base64," + base64.b64encode(png).decode()},
        uri_buffer="data:application/octet-stream;base64,")
    path = tmp_path / "datauri.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


def write_gltf_file_texture(tmp_path) -> str:
    (tmp_path / "tex.png").write_bytes(_png_bytes(_seeded_image(6)))
    doc, blob = _textured_doc({"uri": "tex.png"})
    (tmp_path / "tri.bin").write_bytes(blob)
    doc["buffers"][0]["uri"] = "tri.bin"
    path = tmp_path / "filetex.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


def write_obj_textured(tmp_path) -> str:
    """test_assets.py's two-material OBJ (negative indices), its red
    material textured by a PNG file."""
    path = write_obj(tmp_path)
    mtl = tmp_path / "box.mtl"
    mtl.write_text(mtl.read_text().replace("newmtl blue",
                                           "map_Kd tex.png\n\nnewmtl blue"))
    (tmp_path / "tex.png").write_bytes(_png_bytes(_seeded_image(8)))
    return path


def write_stl_binary(tmp_path) -> str:
    path = str(tmp_path / "quad.stl")
    _write_binary_stl(path, QUAD, normals=[[0, 0, 1], [0, 0, 0]])
    return path


def write_stl_ascii(tmp_path) -> str:
    path = tmp_path / "tri_ascii.stl"
    path.write_text(
        "solid tri\n facet normal 0 0 1\n  outer loop\n"
        "   vertex 0 0 0\n   vertex 1 0 0\n   vertex 0 1 0\n"
        "   vertex -1 0.5 0\n  endloop\n endfacet\nendsolid tri\n")
    return str(path)


def write_ply_ascii(tmp_path) -> str:
    path = tmp_path / "quad.ply"
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 5\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float u\nproperty float v\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "element face 2\nproperty list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 0 0 255 0 0\n1 0 0 1 0 0 255 0\n1 1 0 1 1 0 0 255\n"
        "0 1 0 0 1 10 20 30\n0.5 1.5 0.2 0.5 1 1 1 1\n"
        "4 0 1 2 3\n3 3 2 4\n")
    return str(path)


def write_ply_binary(tmp_path) -> str:
    rng = np.random.default_rng(9)
    verts = rng.uniform(-1, 1, (6, 3)).astype("<f4")
    normals = rng.normal(size=(6, 3)).astype("<f4")
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 6\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property float nx\nproperty float ny\nproperty float nz\n"
              "element face 3\nproperty list uchar uint vertex_indices\n"
              "end_header\n").encode()
    body = np.concatenate([verts, normals], 1).tobytes()
    for face in ([0, 1, 2], [2, 3, 4, 5], [5, 4, 0]):
        body += struct.pack("<B", len(face)) + struct.pack(f"<{len(face)}I", *face)
    path = tmp_path / "bin.ply"
    path.write_bytes(header + body)
    return str(path)


def write_tube(tmp_path) -> str:
    return scenes.write_tube_gltf(tmp_path / "tube.glb", bones=4, keys=6,
                                  segments=8, rings=6)


FILES = {
    "gltf_skinned": make_skinned_gltf,
    "glb_embedded_png": write_glb_embedded,
    "gltf_data_uri_png": write_gltf_data_uri,
    "gltf_file_texture": write_gltf_file_texture,
    "obj_mtl_negative": write_obj_textured,
    "stl_binary": write_stl_binary,
    "stl_ascii": write_stl_ascii,
    "ply_ascii": write_ply_ascii,
    "ply_binary": write_ply_binary,
    "glb_tube": write_tube,
}


# -- comparing ModelData ------------------------------------------------------------

def _fields(obj) -> dict:
    return {k: v for k, v in vars(obj).items()}


def _same_value(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert a == b, what


def assert_same_model(data, jdata):
    assert len(data.meshes) == len(jdata.meshes) > 0
    for k, (m, jm) in enumerate(zip(data.meshes, jdata.meshes)):
        for f in EXACT:
            _same_value(getattr(m, f), getattr(jm, f), f"mesh {k} {f}")
        for f in DERIVED:
            a, b = getattr(m, f), getattr(jm, f)
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, atol=NORMAL_TOL, rtol=0,
                                       err_msg=f"mesh {k} {f}")
        assert (m.material_index, m.name) == (jm.material_index, jm.name)
    assert [vars(m) for m in data.materials] == \
        [vars(m) for m in jdata.materials]
    assert len(data.textures) == len(jdata.textures)
    for t, jt in zip(data.textures, jdata.textures):
        assert (t.path, t.name) == (jt.path, jt.name)
        _same_value(t.rgba, jt.rgba, f"texture {t.path}")
    assert len(data.instance_transforms) == len(jdata.instance_transforms)
    for x, jx in zip(data.instance_transforms, jdata.instance_transforms):
        _same_value(x, jx, "instance transform")
    assert (data.skeleton is None) == (jdata.skeleton is None)
    if data.skeleton is not None:
        sk, jsk = data.skeleton, jdata.skeleton
        assert (sk.name, sk.by_name, sk.by_source_name) == \
            (jsk.name, jsk.by_name, jsk.by_source_name)
        for b, jb in zip(sk.bones, jsk.bones):
            for f, v in _fields(b).items():
                _same_value(v, getattr(jb, f), f"bone {b.name} {f}")
    assert len(data.clips) == len(jdata.clips)
    for c, jclip in zip(data.clips, jdata.clips):
        assert (c.name, c.duration) == (jclip.name, jclip.duration)
        assert len(c.channels) == len(jclip.channels)
        for ch, jch in zip(c.channels, jclip.channels):
            for f, v in _fields(ch).items():
                _same_value(v, getattr(jch, f), f"{c.name} {ch.bone_name} {f}")


@pytest.mark.parametrize("kind", sorted(FILES))
def test_load_model_matches_jax(kind, tmp_path):
    path = FILES[kind](tmp_path)
    data = pml.load_model(path)
    jdata = jml.load_model(path, prefer_native=False)
    assert_same_model(data, jdata)
    if kind in ("glb_embedded_png", "gltf_data_uri_png"):
        assert data.textures[0].rgba is not None
        assert data.materials[0].base_color_texture == 0


def test_obj_ignores_prefer_native(tmp_path):
    """prefer_native takes the port's native loader (Python's parser when
    it cannot be built), whose ModelData is the Python parser's: the
    setting changes where the model is parsed, not what it is."""
    path = write_obj_textured(tmp_path)
    assert_same_model(pml.load_model(path, prefer_native=True),
                      pml.load_model(path, prefer_native=False))


@pytest.mark.parametrize("ext", [".fbx", ".dae"])
def test_unported_formats_raise(ext, tmp_path):
    """.fbx and .dae are ported: a file that is not one raises a clean
    exception from load_model, as in the JAX package, and the directory
    import logs and skips it; an unknown extension still raises."""
    path = tmp_path / f"model{ext}"
    path.write_text("not parsed")
    for load in (pml.load_model, jml.load_model):
        with pytest.raises(Exception) as caught:
            load(str(path))
        assert not isinstance(caught.value, NotImplementedError)
    assert load_scene_directory(str(tmp_path), Registry(), None) == []
    with pytest.raises(ValueError, match="unsupported model format"):
        pml.load_model(str(tmp_path / "model.xyz"))


def test_tube_gltf_is_the_tube(tmp_path):
    """write_tube_gltf's file read by the JAX loader: tube_mesh_arrays'
    mesh (its zero-weight influences index −1) and a clip whose JAX
    player poses the chain as tube_bone_matrices of the key bends,
    interpolated."""
    bones, keys = 5, 7
    path = scenes.write_tube_gltf(tmp_path / "t.glb", bones=bones, keys=keys,
                                  segments=8, rings=4)
    data = jml.load_model(path)
    arrs = scenes.tube_mesh_arrays(8, 4, bones)
    mesh = data.meshes[0]
    for f in ("positions", "normals", "uvs", "colors", "bone_weights"):
        assert np.array_equal(getattr(mesh, f), arrs[f]), f
    from trident_tpu_torch.geometry.mesh import Mesh
    assert np.array_equal(mesh.indices, Mesh(**arrs).indices)
    idx = np.where(arrs["bone_weights"] > 0, arrs["bone_indices"], -1)
    assert np.array_equal(mesh.bone_indices, idx)
    assert len(data.skeleton) == bones and len(data.clips) == 1
    clip = data.clips[0]
    assert clip.name == "bend" and clip.duration == scenes.TUBE_CLIP_SECONDS
    assert len(clip.channels) == bones - 1
    player = JPlayer(data.skeleton)
    player.set_clip(clip)
    player.looping = False              # t = duration is the last key
    for t in np.linspace(0.0, clip.duration, 13):
        np.testing.assert_allclose(
            player.evaluate_at(float(t)),
            scenes.tube_bone_matrices(scenes.tube_bend_at(t, keys), bones),
            atol=1e-5, rtol=0)


def test_rig_gltf_is_make_skinned_gltf(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = scenes.write_rig_gltf(tmp_path / "a")
    theirs = make_skinned_gltf(tmp_path / "b")
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


# -- import into a renderer -----------------------------------------------------------

def _renderers():
    r = Renderer(EngineConfig(render=RenderConfig(width=32, height=32,
                                                  use_pallas=False)),
                 device="cpu")
    jr = JRenderer(JEngineConfig(render=JRenderConfig(width=32, height=32,
                                                      use_pallas=False)))
    reg, jreg = Registry(), JRegistry()
    r.set_active_registry(reg)
    jr.set_active_registry(jreg)
    return r, reg, jr, jreg


def _entity_state(reg, comps) -> list:
    """Every entity's tag, transform and mesh component fields."""
    tag, tr, mesh = comps
    out = []
    for e in reg.alive():
        t, x, m = reg.get(e, tag), reg.get(e, tr), reg.get(e, mesh)
        out.append((e, t.tag, x.position.tolist(), x.rotation.tolist(),
                    x.scale.tolist(), m.mesh_index, m.material_index,
                    m.source_asset_path, m.source_mesh_index))
    return out


@pytest.mark.parametrize("kind", ["gltf_skinned", "glb_embedded_png",
                                  "gltf_file_texture", "obj_mtl_negative"])
def test_import_model_entities_matches_jax(kind, tmp_path):
    """The same entities, transforms, mesh and material indices, texture
    slots (embedded pixels and PNG files) and animation assets."""
    path = FILES[kind](tmp_path)
    r, reg, jr, jreg = _renderers()
    ents = import_model_entities(path, reg, r)
    jents = j_import(path, jreg, jr)
    assert ents == jents
    assert _entity_state(reg, (pc.TagComponent, pc.TransformComponent,
                               pc.MeshComponent)) == \
        _entity_state(jreg, (jc.TagComponent, jc.TransformComponent,
                             jc.MeshComponent))
    assert [m.texture_slot for m in r.geometry.materials] == \
        [m.texture_slot for m in jr.geometry.materials]
    assert r.geometry.model_slots == jr.geometry.model_slots
    for key, slot in jr.textures._by_path.items():
        assert r.textures.lookup(key) == slot
        assert np.array_equal(r.textures._images[slot],
                              jr.textures._images[slot])
    service, jservice = AnimationAssetService.get(), JService.get()
    assert (service.acquire_skeleton(path) is None) == \
        (jservice.acquire_skeleton(path) is None)
    assert len(service.acquire_animation_library(path)) == \
        len(jservice.acquire_animation_library(path))


def test_load_scene_directory_matches_jax(tmp_path):
    for kind in ("stl_binary", "ply_ascii", "glb_embedded_png",
                 "obj_mtl_negative"):
        FILES[kind](tmp_path)
    (tmp_path / "notes.txt").write_text("skipped: not a model")
    r, reg, jr, jreg = _renderers()
    assert load_scene_directory(str(tmp_path), reg, r) == \
        j_load_dir(str(tmp_path), jreg, jr)
    assert _entity_state(reg, (pc.TagComponent, pc.TransformComponent,
                               pc.MeshComponent)) == \
        _entity_state(jreg, (jc.TagComponent, jc.TransformComponent,
                             jc.MeshComponent))
    assert r.geometry.triangle_count() == jr.geometry.triangle_count()


# -- the PNG decoder ------------------------------------------------------------------

# each PNG colour type (1-bit grey and 4-bit palette among them), and with
# a tRNS chunk (a palette's alphas, one transparent grey or RGB value)
PNG_MODES = {"1": None, "L": None, "LA": None, "P": None, "RGB": None,
             "RGBA": None,
             "L_trns": 7, "P_trns": 0, "RGB_trns": (1, 2, 3)}


@pytest.mark.parametrize("mode", sorted(PNG_MODES))
def test_decode_rgba_reads_every_png_colour_type_as_pil(mode, tmp_path):
    rng = np.random.default_rng(12)
    pixels = rng.integers(0, 8, (9, 13, 4)).astype(np.uint8)
    pixels[::2, ::3, :3] = (1, 2, 3)
    img = Image.fromarray(pixels, "RGBA").convert(mode.split("_")[0])
    if mode.startswith("P"):               # six seeded palette entries
        img = Image.fromarray(pixels[..., 0] % 6, "P")
        img.putpalette(rng.integers(0, 256, 18).tolist())
    buf = io.BytesIO()
    img.save(buf, format="PNG", **({} if PNG_MODES[mode] is None else
                                   {"transparency": PNG_MODES[mode]}))
    ref = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGBA"))
    got = pimage.decode_rgba(buf.getvalue())
    assert got.dtype == np.uint8 and got.shape == (9, 13, 4)
    assert np.array_equal(got, ref)
    if mode.endswith("_trns"):             # the key is in the image
        assert (ref[..., 3] == 0).any() and (ref[..., 3] == 255).any()
    path = tmp_path / f"img_{mode}.png"
    path.write_bytes(buf.getvalue())
    rgba, mips = pimage.load_rgba8_mips(str(path))
    assert mips is None and np.array_equal(rgba, ref)
    assert np.array_equal(pimage.read_png(path), ref)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_other_formats_refused(tmp_path):
    """decode_rgba returns None with the JAX function's warning on what it
    cannot decode; load_rgba8 raises ValueError naming the format."""
    buf = io.BytesIO()
    Image.fromarray(_seeded_image(shape=(8, 8, 3))).save(buf, format="JPEG")
    records = _Records()
    log = logging.getLogger("trident.io.image")
    log.addHandler(records)
    try:
        assert pimage.decode_rgba(buf.getvalue()) is None
        assert pimage.decode_rgba(b"\x89PNG\r\n\x1a\ncorrupt") is None
    finally:
        log.removeHandler(records)
    assert len(records.messages) == 2
    assert all(m.startswith("embedded image decode failed")
               for m in records.messages)
    path = tmp_path / "photo.jpg"
    path.write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match=r"\.jpg"):
        pimage.load_rgba8(str(path))
    with pytest.raises(ValueError, match=r"\.jpg"):
        pimage.load_rgba8_mips(str(path))
    # the IHDR's interlace byte (the last of its 13) set: Adam7
    png = bytearray(_png_bytes(_seeded_image()))
    png[8 + 8 + 12] = 1
    interlaced = tmp_path / "interlaced.png"
    interlaced.write_bytes(bytes(png))
    with pytest.raises(ValueError, match="interlace 1"):
        pimage.load_rgba8(str(interlaced))
