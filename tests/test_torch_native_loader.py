"""The port's native OBJ loader (trident_tpu_torch/native/loader.cpp through
assets/native.py) on the CPU.

The shared object builds with g++ into build/trident_tpu_torch/ (never
beside its source). Its ModelData equals the port's load_obj and the JAX
package's load_obj bit for bit on tests/test_native_loader.py's
two-material grid, on the sphere-field OBJ of tools_dev/scenes.py (file
normals, a texture through the MTL, by a relative and by an absolute
path), on a random mesh without normals
(smooth normals computed) and with negative indices; load_model takes it
with prefer_native, and when the library cannot be built, load_model
logs and takes load_obj. Where g++ is missing the tests skip, as the JAX
package's do.
"""

import os

import numpy as np
import pytest
import torch

from trident_tpu.assets.model_loader import load_obj as j_load_obj
from trident_tpu_torch.assets import model_loader, native
from trident_tpu_torch.tools_dev import scenes

from test_native_loader import write_obj
from test_torch_fbx import model_bit_equal

torch.set_num_threads(1)


@pytest.fixture
def native_lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native loader unavailable (no g++?)")
    return lib


def _random_obj(tmp_path) -> str:
    """Random triangles and quads over random positions and UVs, without
    normals, with a material whose values are not floats."""
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(300, 3)).astype(np.float32) * 5
    vt = rng.random((300, 2)).astype(np.float32)
    lines = ["mtllib r.mtl", "usemtl rough"]
    lines += ["v %.9g %.9g %.9g" % tuple(p) for p in pos.astype(np.float64)]
    lines += ["vt %.9g %.9g" % tuple(t) for t in vt.astype(np.float64)]
    for face in rng.integers(1, 301, size=(500, 4)):
        a, b, c, d = face.tolist()
        lines.append(f"f {a}/{a} {b}/{b} {c}/{c} {d}/{d}" if a % 2
                     else f"f {a}/{a} {b}/{b} {c}/{c}")
    (tmp_path / "r.mtl").write_text(
        "newmtl rough\nKd 0.3 0.7 0.11\nd 0.5\nNs 37\nPm 0.1\n"
        "map_Kd textures/rough.png\n")
    path = tmp_path / "r.obj"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _field_obj(tmp_path) -> str:
    return scenes.write_field_obj(tmp_path, "checker.ktx2", grid=2)


def _field_obj_absolute_texture(tmp_path) -> str:
    """The field with an absolute map_Kd path, which stands alone."""
    return scenes.write_field_obj(tmp_path, str(tmp_path / "t" / "a.svg"),
                                  grid=1)


def _negative_obj(tmp_path) -> str:
    (tmp_path / "neg.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf -4 -3 -2\nf -3 -1 -2\n")
    return str(tmp_path / "neg.obj")


FILES = {"grid": write_obj, "random_no_normals": _random_obj,
         "field": _field_obj, "negative_indices": _negative_obj,
         "field_absolute_texture": _field_obj_absolute_texture}


@pytest.mark.parametrize("name", sorted(FILES))
def test_native_matches_python(name, tmp_path, native_lib):
    path = FILES[name](tmp_path)
    nat = native.load_obj_native(path)
    assert nat is not None and nat.meshes
    model_bit_equal(nat, model_loader.load_obj(path))
    model_bit_equal(nat, j_load_obj(path))
    model_bit_equal(model_loader.load_model(path, prefer_native=True), nat)


def test_field_obj_is_the_field(tmp_path, native_lib):
    """write_field_obj's file loads back to field_mesh_arrays: the same
    triangles, corner for corner, with the sphere's normals."""
    path = _field_obj(tmp_path)
    mesh = native.load_obj_native(path).meshes[0]
    f = scenes.field_mesh_arrays(2)
    assert mesh.triangle_count == f["indices"].size // 3 == 4 * 768
    for key in ("positions", "normals", "uvs"):
        got = getattr(mesh, key)[mesh.indices].reshape(mesh.triangle_count, -1)
        want = f[key][f["indices"]].reshape(mesh.triangle_count, -1)
        assert np.array_equal(np.unique(got, axis=0), np.unique(want, axis=0))


def test_library_builds_beside_the_kernels(native_lib):
    so = native.BUILD_DIR / native.SO_NAME
    assert so.is_file() and (native.BUILD_DIR / (native.SO_NAME
                                                 + ".key")).is_file()
    assert so.parent.name == "trident_tpu_torch"
    assert so.parent.parent.name == "build"
    assert not any(p.suffix == ".so" for p in native._SRC.parent.iterdir())


def test_failed_build_falls_back_to_python(tmp_path, monkeypatch):
    path = write_obj(tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "_SRC", tmp_path / "missing.cpp")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert native.get_lib() is None
    assert native.load_obj_native(path) is None
    model_bit_equal(model_loader.load_model(path, prefer_native=True),
                    j_load_obj(path))
    assert not os.path.exists(tmp_path / "build" / native.SO_NAME)
