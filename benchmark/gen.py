"""The benchmark's own scene data, made from numbers alone (numpy, struct,
json): the UV sphere, the checker texture, the sphere field's layout and
per-frame rotations, the skinned tube, its looping clip, the crowd's layout
and the .glb that carries tube and clip into the program's importer.

Both sides read these: the program gets them through its public scene
API (meshes, textures, transforms, a model file), and the plain reference
(benchmark/reference/) gets the same arrays. They are copies of the
generators the port's tools used for the same scenes, kept here so that
a change to the program cannot change the yardstick.
"""

from __future__ import annotations

import json
import struct

import numpy as np


def uv_sphere(rings: int, segments: int, radius: float) -> dict:
    """A UV sphere: (rings + 1) × (segments + 1) vertices, 2·rings·segments
    triangles, positions, unit normals and UVs (u around, 1 − v down)."""
    v = np.arange(rings + 1, dtype=np.float32) / rings
    u = np.arange(segments + 1, dtype=np.float32) / segments
    phi = v * np.pi
    theta = u * 2.0 * np.pi
    sin_phi, cos_phi = np.sin(phi)[:, None], np.cos(phi)[:, None]
    sin_theta, cos_theta = np.sin(theta)[None, :], np.cos(theta)[None, :]
    px = radius * sin_phi * cos_theta
    py = np.broadcast_to(radius * cos_phi, px.shape)
    pz = radius * sin_phi * sin_theta
    positions = np.stack([px, py, pz], axis=-1).reshape(-1, 3)
    normals = positions / np.maximum(
        np.linalg.norm(positions, axis=-1, keepdims=True), 1e-8)
    uu = np.broadcast_to(u[None, :], px.shape)
    vv = np.broadcast_to(v[:, None], px.shape)
    uvs = np.stack([uu, 1.0 - vv], axis=-1).reshape(-1, 2)
    row = segments + 1
    r_grid, s_grid = np.meshgrid(np.arange(rings), np.arange(segments),
                                 indexing="ij")
    i0 = r_grid * row + s_grid
    i1 = (r_grid + 1) * row + s_grid
    i2 = (r_grid + 1) * row + s_grid + 1
    i3 = r_grid * row + s_grid + 1
    indices = np.stack([i0, i2, i1, i0, i3, i2], axis=-1).reshape(-1)
    return dict(positions=positions.astype(np.float32),
                normals=normals.astype(np.float32),
                uvs=uvs.astype(np.float32), indices=indices.astype(np.int32))


def checker(size: int, cells: int, color_a, color_b) -> np.ndarray:
    """(size, size, 4) uint8 checkerboard of cells × cells squares."""
    y, x = np.mgrid[0:size, 0:size]
    cell = size // cells
    mask = ((x // cell) + (y // cell)) % 2 == 0
    return np.where(mask[..., None], np.array(color_a, np.uint8),
                    np.array(color_b, np.uint8)).astype(np.uint8)


def field_positions(grid: int, spacing: float) -> np.ndarray:
    """(grid², 3) f32 centres of a grid × grid field in the z = 0 plane,
    in creation order (i outer, j inner)."""
    i, j = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    pos = np.stack([(i - grid / 2) * spacing, (j - grid / 2) * spacing,
                    np.zeros_like(i, dtype=np.float64)], -1)
    return pos.reshape(-1, 3).astype(np.float32)


def field_rotations(start_deg: float, step_deg: float, frames: int,
                    pitch_ratio: float) -> np.ndarray:
    """(frames, 3) f32 Euler rotations (degrees) of every field entity on
    each frame of a cycle: angle a_k = start + k·step, rotation
    (pitch_ratio·a_k, a_k, 0)."""
    a = start_deg + step_deg * np.arange(frames, dtype=np.float64)
    return np.stack([pitch_ratio * a, a, np.zeros_like(a)], -1).astype(
        np.float32)


def tube_mesh(segments: int, rings: int, bones: int, length: float,
              radius: float) -> dict:
    """One skinned tube: a radius-`radius` cylinder along +y over
    [0, length] (the UV sphere's vertex layout and winding, rings from
    the top down), outward normals, UVs, a colour ramp along the axis, and
    each vertex skinned to the two bones around its height (indices b,
    b + 1, weights 1 − f, f; the other two influences index −1, weight 0)."""
    v = np.arange(rings + 1, dtype=np.float32) / rings
    u = np.arange(segments + 1, dtype=np.float32) / segments
    theta = u * np.float32(2.0 * np.pi)
    y = np.broadcast_to((length * (1.0 - v))[:, None],
                        (rings + 1, segments + 1))
    cx = np.broadcast_to(np.cos(theta)[None, :], y.shape)
    cz = np.broadcast_to(np.sin(theta)[None, :], y.shape)
    positions = np.stack([radius * cx, y, radius * cz], axis=-1).reshape(-1, 3)
    normals = np.stack([cx, np.zeros_like(cx), cz], axis=-1).reshape(-1, 3)
    uvs = np.stack([np.broadcast_to(u[None, :], y.shape),
                    np.broadcast_to(1.0 - v[:, None], y.shape)],
                   axis=-1).reshape(-1, 2)
    t = (y / length).reshape(-1)
    colors = np.stack([0.4 + 0.6 * t, 0.9 - 0.5 * t, 0.5 + 0.0 * t], -1)
    pos_b = t * (bones - 1)
    b0 = np.minimum(np.floor(pos_b), max(bones - 2, 0)).astype(np.int32)
    f = (pos_b - b0).astype(np.float32)
    n = positions.shape[0]
    bone_indices = np.full((n, 4), -1, np.int32)
    bone_weights = np.zeros((n, 4), np.float32)
    bone_indices[:, 0], bone_weights[:, 0] = b0, 1.0 - f
    if bones > 1:
        bone_indices[:, 1], bone_weights[:, 1] = b0 + 1, f
    row = segments + 1
    r_grid, s_grid = np.meshgrid(np.arange(rings), np.arange(segments),
                                 indexing="ij")
    i0 = r_grid * row + s_grid
    i1 = (r_grid + 1) * row + s_grid
    i2 = (r_grid + 1) * row + s_grid + 1
    i3 = r_grid * row + s_grid + 1
    indices = np.stack([i0, i2, i1, i0, i3, i2], -1).reshape(-1)
    return dict(positions=positions.astype(np.float32),
                indices=indices.astype(np.int32),
                normals=normals.astype(np.float32),
                colors=colors.astype(np.float32),
                uvs=uvs.astype(np.float32), bone_indices=bone_indices,
                bone_weights=bone_weights)


def crowd_layout(grid: int, spacing: float, scale: float,
                 length: float) -> tuple:
    """((grid², 3) positions, (grid², 3) scales) f32 of a grid × grid
    crowd in creation order: `spacing` apart in x and y, centred on the
    origin, each scaled by `scale` and standing on its base."""
    half = (grid - 1) / 2.0
    i, j = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    pos = np.stack([(i - half) * spacing,
                    (j - half) * spacing - 0.5 * length * scale,
                    np.zeros_like(i, dtype=np.float64)], -1).reshape(-1, 3)
    return (pos.astype(np.float32),
            np.full((grid * grid, 3), scale, np.float32))


def clip_keys(keys: int, seconds: float, amplitude: float) -> tuple:
    """(times (keys,) f32, bends (keys,) f64) of the tube's looping clip:
    key k at seconds·k/(keys − 1) bends the tube by
    amplitude·sin(2πk/keys) radians about z."""
    k = np.arange(keys)
    return ((seconds * k / (keys - 1)).astype(np.float32),
            amplitude * np.sin(2.0 * np.pi * k / keys))


def _glb_buffer(arrays: list) -> tuple:
    """(blob, bufferViews) of numpy arrays laid end to end, each view
    4-byte aligned."""
    blob, views = b"", []
    for a in arrays:
        blob += b"\0" * (-len(blob) % 4)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": a.nbytes})
        blob += a.tobytes()
    return blob + b"\0" * (-len(blob) % 4), views


def write_tube_glb(path, mesh: dict, bones: int, length: float,
                   times: np.ndarray, bends: np.ndarray,
                   material: dict) -> str:
    """One skinned tube as a .glb at `path` → the path: tube_mesh's mesh
    (POSITION, NORMAL, TEXCOORD_0, COLOR_0, JOINTS_0 / WEIGHTS_0 with the
    −1 influences as joint 0 at weight 0; each triangle's winding
    reversed, as glTF's counter-clockwise front faces need), one material
    (`material`: base_color, metallic, roughness), a chain of `bones`
    joints up +y (joint 0 at the base, each next one length/(bones − 1)
    above) with their inverse binds, and one looping LINEAR clip "bend":
    key k turns every joint but the root about z by bends_k/(bones − 1)."""
    joints = np.maximum(mesh["bone_indices"], 0).astype(np.uint16)
    tri = mesh["indices"].reshape(-1, 3)[:, ::-1]
    indices = np.ascontiguousarray(tri).reshape(-1).astype(np.uint32)
    seg = length / max(bones - 1, 1)
    inv_bind = np.tile(np.eye(4, dtype=np.float32), (bones, 1, 1))
    inv_bind[:, 1, 3] = -seg * np.arange(bones, dtype=np.float32)
    keys = times.shape[0]
    half = bends / max(bones - 1, 1) / 2.0
    rots = np.stack([np.zeros(keys), np.zeros(keys), np.sin(half),
                     np.cos(half)], -1).astype(np.float32)      # xyzw
    arrays = [mesh["positions"], mesh["normals"], mesh["uvs"],
              mesh["colors"], joints, mesh["bone_weights"], indices,
              np.ascontiguousarray(inv_bind.transpose(0, 2, 1)), times, rots]
    blob, views = _glb_buffer(arrays)
    v = mesh["positions"].shape[0]
    kinds = [(5126, v, "VEC3"), (5126, v, "VEC3"), (5126, v, "VEC2"),
             (5126, v, "VEC3"), (5123, v, "VEC4"), (5126, v, "VEC4"),
             (5125, indices.size, "SCALAR"), (5126, bones, "MAT4"),
             (5126, keys, "SCALAR"), (5126, keys, "VEC4")]
    accessors = [{"bufferView": i, "componentType": ct, "count": n,
                  "type": kind} for i, (ct, n, kind) in enumerate(kinds)]
    accessors[0].update(min=mesh["positions"].min(0).tolist(),
                        max=mesh["positions"].max(0).tolist())
    accessors[8].update(min=[float(times[0])], max=[float(times[-1])])
    nodes = [{"name": f"joint{j}",
              "translation": [0.0, seg if j else 0.0, 0.0],
              **({"children": [j + 1]} if j + 1 < bones else {})}
             for j in range(bones)]
    nodes.append({"name": "tube", "mesh": 0, "skin": 0})
    doc = {
        "asset": {"version": "2.0", "generator": "benchmark/gen.py"},
        "scene": 0,
        "scenes": [{"nodes": [0, bones]}],
        "nodes": nodes,
        "skins": [{"joints": list(range(bones)), "inverseBindMatrices": 7}],
        "materials": [{"name": "tube", "pbrMetallicRoughness": {
            "baseColorFactor": list(material["base_color"]),
            "metallicFactor": material["metallic"],
            "roughnessFactor": material["roughness"]}}],
        "meshes": [{"name": "tube", "primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2,
                           "COLOR_0": 3, "JOINTS_0": 4, "WEIGHTS_0": 5},
            "indices": 6, "material": 0}]}],
        "animations": [{
            "name": "bend",
            "samplers": [{"input": 8, "output": 9,
                          "interpolation": "LINEAR"}],
            "channels": [{"sampler": 0,
                          "target": {"node": j, "path": "rotation"}}
                         for j in range(1, bones)]}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    text = json.dumps(doc).encode()
    text += b" " * (-len(text) % 4)
    glb = (struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(text) + 8
                       + len(blob))
           + struct.pack("<II", len(text), 0x4E4F534A) + text
           + struct.pack("<II", len(blob), 0x004E4942) + blob)
    with open(path, "wb") as f:
        f.write(glb)
    return str(path)


def field_motion(cfg: dict, seed: int, cycle: int) -> np.ndarray:
    """The sphere field's traffic from `seed`: (cycle, 3) Euler rotations,
    frame k of a run turning every entity to row k % cycle; the start
    angle and the step per frame drawn from the configuration's ranges."""
    m = cfg["motion"]
    rng = np.random.default_rng(seed)
    start = rng.uniform(*m["start_deg"])
    step = rng.uniform(*m["step_deg"])
    return field_rotations(start, step, cycle, m["pitch_ratio"])


def crowd_motion(cfg: dict, seed: int) -> tuple:
    """The crowd's traffic from `seed`: each character's clip phase
    (seconds into its clip when play starts) and playback speed, drawn
    from the configuration's ranges."""
    m = cfg["motion"]
    n = cfg["grid"] ** 2
    rng = np.random.default_rng(seed)
    phases = rng.uniform(*m["phase_s"], size=n)
    speeds = rng.uniform(*m["speed"], size=n)
    return phases, speeds


def clip_times(phases: np.ndarray, speeds: np.ndarray, dt: float,
               duration: float, updates: int) -> np.ndarray:
    """Each character's clip time after `updates` steps of dt at its
    speed from its phase, wrapping at the clip's end (float64, one step
    at a time, as a looping player advances)."""
    t = np.asarray(phases, np.float64).copy()
    for _ in range(updates):
        t = np.mod(t + dt * speeds, duration)
    return t
