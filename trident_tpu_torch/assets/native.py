"""ctypes binding for the native asset-packing core (native/loader.cpp).

The port's own copy of trident_tpu/assets/native.py. The shared object is
built on demand with g++ (`g++ -O3 -ffp-contract=off -shared -fPIC
-std=c++17`) into build/trident_tpu_torch/ under the repository root,
beside the kernel library of _build.py, never next to its source; a stamp
beside it holds a hash of the source and the flags, and any change
rebuilds. When the build or the load fails, get_lib() logs and returns
None, and load_obj_native returns None: load_model then takes the pure-
Python load_obj. `get_lib() is not None` says whether the native path is
available.

The native loader computes load_obj's ModelData bit for bit (positions,
normals, tangents, bitangents, UVs, indices and their Morton order,
materials, texture paths, mesh names) for files whose materials are all
defined in their MTL, used in the order they are defined, with at most
one map_Kd each (the layout exporters write). Otherwise it keeps the
same triangles and values, but lists every MTL material in file order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from trident_tpu_torch._build import BUILD_DIR
from trident_tpu_torch.core.log import get_logger

logger = get_logger("assets.native")

_SRC = Path(__file__).resolve().parent.parent / "native" / "loader.cpp"
SO_NAME = "libttnative.so"
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def _source_key() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return h.hexdigest()


def _build() -> Optional[Path]:
    """The shared object, compiled unless its stamp matches the source and
    flags; None (logged) when g++ fails or is missing."""
    so, stamp = BUILD_DIR / SO_NAME, BUILD_DIR / (SO_NAME + ".key")
    try:
        key = _source_key()
        if so.is_file() and stamp.is_file() and stamp.read_text() == key:
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{SO_NAME}.{os.getpid()}.tmp"
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        stamp.write_text(key)
        return so
    except (OSError, subprocess.SubprocessError) as exc:   # no g++ too
        logger.warning("native loader build failed: %s", exc)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native loader, built on first call; None when it cannot
    be built or loaded."""
    global _lib, _load_failed
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        so = _build()
        if so is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as exc:
            logger.warning("native loader unavailable: %s", exc)
            _load_failed = True
            return None
        lib.tt_load_obj.restype = ctypes.c_void_p
        lib.tt_load_obj.argtypes = [ctypes.c_char_p]
        lib.tt_mesh_count.argtypes = [ctypes.c_void_p]
        lib.tt_material_count.argtypes = [ctypes.c_void_p]
        lib.tt_mesh_vertex_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tt_mesh_index_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tt_mesh_material.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tt_mesh_name.restype = ctypes.c_char_p
        lib.tt_mesh_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.tt_mesh_copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     f32p, f32p, f32p, f32p, f32p, i32p]
        lib.tt_material_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, f64p, f64p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.tt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def load_obj_native(path: str):
    """Native OBJ load → ModelData, or None when unavailable."""
    from trident_tpu_torch.assets.model_loader import ModelData, TextureRef
    from trident_tpu_torch.geometry.mesh import Material, Mesh

    lib = get_lib()
    if lib is None:
        return None
    handle = lib.tt_load_obj(os.path.abspath(path).encode())
    if not handle:
        return None
    try:
        data = ModelData()
        tex_index: dict = {}
        for i in range(lib.tt_material_count(handle)):
            base = np.zeros(4, np.float64)
            mr = np.zeros(2, np.float64)
            name = ctypes.create_string_buffer(256)
            tex = ctypes.create_string_buffer(1024)
            lib.tt_material_get(handle, i, base, mr, name, 256, tex, 1024)
            mat = Material(base_color=tuple(float(x) for x in base),
                           metallic=float(mr[0]), roughness=float(mr[1]),
                           name=name.value.decode())
            tex_path = tex.value.decode()
            if tex_path:
                if tex_path not in tex_index:
                    tex_index[tex_path] = len(data.textures)
                    data.textures.append(TextureRef(
                        path=os.path.normpath(tex_path),
                        name=os.path.basename(tex_path)))
                mat.base_color_texture = tex_index[tex_path]
            data.materials.append(mat)

        for i in range(lib.tt_mesh_count(handle)):
            v = lib.tt_mesh_vertex_count(handle, i)
            n_idx = lib.tt_mesh_index_count(handle, i)
            pos = np.empty((v, 3), np.float32)
            nrm = np.empty((v, 3), np.float32)
            tan = np.empty((v, 3), np.float32)
            bit = np.empty((v, 3), np.float32)
            uv = np.empty((v, 2), np.float32)
            idx = np.empty(n_idx, np.int32)
            lib.tt_mesh_copy(handle, i, pos.ravel(), nrm.ravel(), tan.ravel(),
                             bit.ravel(), uv.ravel(), idx)
            data.meshes.append(Mesh(
                pos, idx, normals=nrm, tangents=tan, bitangents=bit, uvs=uv,
                material_index=lib.tt_mesh_material(handle, i),
                name=(lib.tt_mesh_name(handle, i).decode()
                      or os.path.basename(path)),
                spatial_sort=False))   # native loader already Morton-sorts
            data.instance_transforms.append(np.eye(4, dtype=np.float32))
        return data
    finally:
        lib.tt_free(handle)
