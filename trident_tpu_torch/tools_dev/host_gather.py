"""Host draw gathering, the per-record loops against the batched forms.

The Renderer gathers a frame's draws and packs their per-draw rows all at
once in numpy (render/frame.py::gather_draw_batch, build_draw_params_host).
`loop_draw_params` is the baseline they replaced: one component lookup
and one row write per entity, as the JAX package's gather_mesh_draws and
build_draw_params do it. `gather_ab` holds the two bit-equal on a scene
and times them, with the frame's whole host side (Renderer.frame_bundle:
draws, plan, rows, lights, packed into the two blobs) beside them,
alternating in one window:

    python3 -m trident_tpu_torch.tools_dev.host_gather [--grid 36] [--pairs 10]

renders nothing (host work only, the plan cached on the device named by
--device, the card unless it says cpu) and prints the three medians.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Optional, Tuple

import numpy as np

from trident_tpu_torch.ecs.components import (
    MeshComponent,
    TextureComponent,
    TransformComponent,
)
from trident_tpu_torch.mathx.transforms import compose_trs
from trident_tpu_torch.render.frame import (
    DrawRecord,
    build_draw_params_host,
    gather_draw_batch,
)
from trident_tpu_torch.render.types import DrawParams


def loop_draw_params(registry, cache, num_draws: int,
                     material_table: Optional[np.ndarray] = None
                     ) -> Tuple[DrawParams, np.ndarray]:
    """(DrawParams, shade table) of the visible mesh entities as numpy,
    the way the per-record loops made them: one DrawRecord per entity
    (its lookups and defaults), then one row write per record (skinned
    draws are not ported and not looked for)."""
    drawn = []
    for entity, (transform, mesh) in registry.view(TransformComponent,
                                                   MeshComponent):
        if mesh.visible and 0 <= mesh.mesh_index < len(cache.meshes):
            drawn.append((entity, transform, mesh))
    records = []
    if drawn:
        models = compose_trs(*(np.stack([np.asarray(getattr(t, f),
                                                     np.float32)
                                         for _e, t, _m in drawn])
                               for f in ("position", "rotation", "scale")))
    for k, (entity, _t, mesh) in enumerate(drawn):
        mi = (mesh.material_index
              if 0 <= mesh.material_index < len(cache.materials) else 0)
        slot = cache.materials[mi].texture_slot
        uv_scale, uv_offset = np.ones(2, np.float32), np.zeros(2, np.float32)
        tiling = 1.0
        tex = registry.try_get(entity, TextureComponent)
        if tex is not None:
            slot = tex.slot
            uv_scale = np.asarray(tex.uv_scale, np.float32)
            uv_offset = np.asarray(tex.uv_offset, np.float32)
            tiling = float(tex.tiling)
        records.append(DrawRecord(
            entity=entity, mesh_index=mesh.mesh_index, model=models[k],
            tint=np.asarray(mesh.tint, np.float32), uv_scale=uv_scale,
            uv_offset=uv_offset, tiling=tiling, texture_slot=slot,
            material_index=mi))
    d = num_draws
    model = np.tile(np.eye(4, dtype=np.float32), (d, 1, 1))
    tint = np.ones((d, 4), np.float32)
    uv_scale = np.ones((d, 2), np.float32)
    uv_offset = np.zeros((d, 2), np.float32)
    tiling = np.ones(d, np.float32)
    texture_slot = np.zeros(d, np.int32)
    material_index = np.zeros(d, np.int32)
    shade = np.zeros((d, 8), np.float32)
    shade[:, 0:4] = 1.0
    shade[:, 5] = 1.0  # roughness
    shade[:, 6] = 1.0  # ambient strength
    for i, rec in enumerate(records[:d]):
        model[i] = rec.model
        tint[i] = rec.tint
        if (material_table is not None
                and 0 <= rec.material_index < material_table.shape[0]):
            mat = material_table[rec.material_index]
            shade[i, 0:4] = mat[0:4] * rec.tint
            shade[i, 4:7] = mat[4:7]   # metallic, roughness, ambient
        else:
            shade[i, 0:4] = rec.tint
        shade[i, 7] = float(rec.texture_slot)
        uv_scale[i] = rec.uv_scale
        uv_offset[i] = rec.uv_offset
        tiling[i] = rec.tiling
        texture_slot[i] = rec.texture_slot
        material_index[i] = rec.material_index
    model_flat = model.reshape(d, 16)
    params = DrawParams(
        model=model, xform_a=model_flat[:, :12].copy(),
        xform_b=np.concatenate(
            [model_flat[:, 12:16], uv_scale, uv_offset, tiling[:, None],
             np.zeros((d, 3), np.float32)], axis=1),
        tint=tint, uv_scale=uv_scale, uv_offset=uv_offset, tiling=tiling,
        texture_slot=texture_slot, material_index=material_index,
        bone_offset=np.full(d, -1, np.int32),
        bone_count=np.zeros(d, np.int32))
    return params, shade


def batch_draw_params(registry, cache, num_draws: int,
                      material_table: Optional[np.ndarray] = None
                      ) -> Tuple[DrawParams, np.ndarray]:
    """The same through the Renderer's batched forms."""
    return build_draw_params_host(gather_draw_batch(registry, cache),
                                  num_draws, material_table)


def same_params(a, b) -> bool:
    """Whether two (DrawParams, shade) pairs agree in every byte."""
    return a[1].tobytes() == b[1].tobytes() and all(
        x.dtype == y.dtype and x.tobytes() == y.tobytes()
        for x, y in zip(a[0], b[0]))


def gather_ab(r, pairs: int = 10) -> dict:
    """Host ms (medians of 2·pairs each) of the loops, the batched forms
    and Renderer `r`'s whole frame host side (frame_bundle of viewport 0,
    which runs the batched forms), timed in the order loop, batch, bundle,
    bundle, batch, loop `pairs` times in one window, on the scene as it
    stands. Raises if the loops and the batched forms differ."""
    reg, cache = r.registry, r.geometry
    nd = r.frame_bundle().state.plan.num_draws
    mt = cache.material_table()
    legs = {"loop": lambda: loop_draw_params(reg, cache, nd, mt),
            "batch": lambda: batch_draw_params(reg, cache, nd, mt),
            "frame_bundle": r.frame_bundle}
    if not same_params(legs["loop"](), legs["batch"]()):
        raise RuntimeError("the batched draw gathering differs from the "
                             "per-record loops")
    ms = {name: [] for name in legs}
    for _pair in range(pairs):
        for name in ("loop", "batch", "frame_bundle", "frame_bundle",
                     "batch", "loop"):
            t0 = time.perf_counter()
            legs[name]()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(v) for name, v in ms.items()}


def main() -> None:
    from trident_tpu_torch import resolve_device
    from trident_tpu_torch.tools_dev.scenes import build_bench_scene, rotate

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=36,
                    help="spheres per side (36: spheres1080_1m)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="where the plan is cached (default: the card)")
    args = ap.parse_args()
    r, reg = build_bench_scene(args.grid, resolve_device(args.device))
    rotate(reg, 3)
    ms = gather_ab(r, args.pairs)
    print(f"host draw gathering, {args.grid}x{args.grid} sphere grid, "
          f"bit-equal: " + ", ".join(f"{n} {v:.3f} ms"
                                     for n, v in ms.items()), flush=True)


if __name__ == "__main__":
    main()
