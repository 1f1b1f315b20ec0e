"""The port's loaders on corrupted and truncated files, on the CPU: the
fbx, dae, ktx2 and svg cases of tests/test_loader_fuzz.py with the same
mutations (its _mutations, the conftest's seeded rng), run on the port's
loaders. Each mutation must raise a clean Python exception or load, and
the port must do what the JAX package does with it: raise the same
exception type, or load the same result bit for bit. The OBJ case runs
the port's native loader (load_model's default path), which must survive
every mutation.
"""

import numpy as np
import pytest
import torch

from trident_tpu.assets.ktx2 import load_ktx2_rgba8 as j_load_ktx2
from trident_tpu.assets.model_loader import load_model as j_load_model
from trident_tpu.io.svg import rasterize_svg_file as j_rasterize_file
from trident_tpu_torch.assets.ktx2 import load_ktx2_rgba8, write_ktx2
from trident_tpu_torch.assets.model_loader import load_model
from trident_tpu_torch.io.svg import rasterize_svg_file

from test_fbx import _write_static_cube
from test_loader_fuzz import _mutations
from test_torch_fbx import model_bit_equal

torch.set_num_threads(1)

DAE = (b'<?xml version="1.0"?><COLLADA xmlns="http://www.collada.org/'
       b'2005/11/COLLADASchema" version="1.4.1"><library_geometries>'
       b'<geometry id="g"><mesh><source id="p"><float_array id="pa" '
       b'count="9">0 0 0 1 0 0 0 1 0</float_array></source>'
       b'<vertices id="v"><input semantic="POSITION" source="#p"/>'
       b'</vertices><triangles count="1"><input semantic="VERTEX" '
       b'source="#v" offset="0"/><p>0 1 2</p></triangles></mesh>'
       b'</geometry></library_geometries></COLLADA>')
SVG = (b'<svg xmlns="http://www.w3.org/2000/svg" width="16" height="16">'
       b'<path d="M2 2 C 4 1, 8 1, 14 14 A 3 3 0 1 1 2 14 Z" '
       b'fill="red" stroke="blue"/></svg>')


def _outcome(load, path):
    """load(path), or the type of the exception it raised."""
    try:
        return load(path)
    except Exception as exc:       # a clean exception is an outcome too
        return type(exc)


def _same_outcome(got, want, same):
    if isinstance(want, type):
        assert got is want, (got, want)
    else:
        assert not isinstance(got, type), got
        same(got, want)


def _same_array(a, b):
    assert a.dtype == b.dtype and np.array_equal(a, b)


def _fuzz(tmp_path, rng, src: bytes, ext: str, port, jax, same):
    for i, m in enumerate(_mutations(src, rng)):
        p = tmp_path / f"f{i}{ext}"
        p.write_bytes(m)
        _same_outcome(_outcome(port, str(p)), _outcome(jax, str(p)), same)


def test_fbx_fuzz(tmp_path, rng):
    good = tmp_path / "good.fbx"
    _write_static_cube(str(good))
    _fuzz(tmp_path, rng, good.read_bytes(), ".fbx", load_model,
          j_load_model, model_bit_equal)


def test_dae_fuzz(tmp_path, rng):
    _fuzz(tmp_path, rng, DAE, ".dae", load_model, j_load_model,
          model_bit_equal)


def test_ktx2_fuzz(tmp_path, rng):
    good = tmp_path / "good.ktx2"
    write_ktx2(str(good), np.zeros((8, 8, 4), np.uint8), scheme=3)
    _fuzz(tmp_path, rng, good.read_bytes(), ".ktx2", load_ktx2_rgba8,
          j_load_ktx2, _same_array)


def test_svg_fuzz(tmp_path, rng):
    _fuzz(tmp_path, rng, SVG, ".svg", rasterize_svg_file, j_rasterize_file,
          _same_array)


def test_obj_fuzz_native(tmp_path, rng):
    from trident_tpu_torch.assets.native import get_lib

    if get_lib() is None:
        pytest.skip("native loader unavailable (no g++?)")
    src = ("mtllib m.mtl\nusemtl m\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\n"
           "vt 1 0\nvt 0 1\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1\n"
           "f -1/-1/-1 -2/-2/-1 -3/-3/-1\n").encode()
    (tmp_path / "m.mtl").write_text("newmtl m\nKd 1 0.5 0.25\nmap_Kd t.png\n")
    for i, m in enumerate(_mutations(src, rng, n=24)):
        p = tmp_path / f"f{i}.obj"
        p.write_bytes(m)
        out = _outcome(load_model, str(p))
        if not isinstance(out, type):
            for mesh in out.meshes:
                assert mesh.indices.size % 3 == 0
