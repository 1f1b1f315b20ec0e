"""The port's fused visibility + resolve pass (the `fuse` knob) and its
tiled resolve against the JAX package's `fused_visibility_resolve_pallas`
(interpret mode), and against the port's own split path.

The JAX side runs one jit on a 3×3 sphere grid at 128² (test_torch_resolve
.py's scene): draw rows → corner stage → resolve columns → the fused
kernel; the port bins the same triangle setup and resolves against the
same (RW, T) record columns, carried across as its (T, RW) rows.
Tolerances, with their reasons:
  * in this process XLA:CPU contracts the interpreted kernel's edge
    functions and plane evaluations into FMAs: winner ids may differ only
    at mismatches test_torch_raster.py classifies (depth ties within 2
    ulps or edge flips; 2 of 6,493 covered pixels measured), and where
    the ids agree depth is within 1e-6 and the attributes within
    test_torch_resolve.py's tolerances for the resolve pass — the
    material, texture and colour channels exactly, normal and UV within
    5e-5 relative to max(1, |value|), the mip level within 1e-4;
  * in a child process whose XLA:CPU may not emit FMAs
    (--xla_cpu_max_isa=AVX): depth and ids bit-equal, every attribute
    bit-equal except the mip level, ½·log2 of the footprint, within one
    ulp (XLA's log2 and PyTorch's are different approximations);
  * against the port's split path (visibility, then resolve): bit-equal,
    in both attribute layouts.
Run as a script, this file is the child: `python test_torch_fused.py
OUT.npz` writes the JAX side's setup, records and fused outputs.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ops import planes as jplanes
from trident_tpu.ops import raster_pallas as jrp
from trident_tpu.ops import resolve_pallas as jrsp
from trident_tpu.ops.corner import corner_stage
from trident_tpu.ops.vertex import TriangleSetup as JTriangleSetup

from trident_tpu_torch.ops import raster, resolve
from trident_tpu_torch.ops.planes import records_from_reference
from trident_tpu_torch.render.types import from_numpy

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
W = H = 128
NTX = NTY = W // raster.TILE


def _jax_fused():
    """(setup fields, cols, depth_t, tri_t, attrs_t) as numpy: the JAX
    fused kernel on test_torch_resolve.py's sphere grid."""
    def run(params, shade, cam, corner_t, tri_draw, valid, sizes):
        from trident_tpu.ops.corner import build_draw_rows

        tex_row = sizes[params.texture_slot].astype(jnp.float32)
        rows = build_draw_rows(
            params, cam, W, H,
            draw_consts=jnp.concatenate([shade, tex_row], axis=1))
        cs = corner_stage(corner_t, rows, tri_draw, valid, W, H)
        cols = jplanes.build_resolve_cols_planar(cs.cols)
        _b, depth, tri, attrs, _w = jrsp.fused_visibility_resolve_pallas(
            cs.setup, jplanes.chunk_resolve_cols(cols, jrp.CHUNK), W, H,
            interpret=True, setup_cols=cs.cols.setup)
        return cs.setup, cols, depth[:, 0], tri[:, 0], attrs

    setup, cols, depth, tri, attrs = jax.jit(run)(*_scene_inputs())
    fields = {f: np.array(getattr(setup, f)) for f in setup._fields}
    return fields, *[np.array(a) for a in (cols, depth, tri, attrs)]


def _scene_inputs():
    """The JAX Renderer's inputs of test_torch_resolve.py's scene."""
    from trident_tpu.core.config import EngineConfig, RenderConfig
    from trident_tpu.ecs import (
        MeshComponent,
        Registry,
        TextureComponent,
        TransformComponent,
    )
    from trident_tpu.geometry.primitives import PrimitiveType
    from trident_tpu.io.image import checkerboard
    from trident_tpu.render.frame import build_draw_params, gather_mesh_draws
    from trident_tpu.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(width=W, height=H,
                                                  use_pallas=True)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    mesh = r.ensure_primitive(PrimitiveType.SPHERE)
    for i in range(3):
        for j in range(3):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array([(i - 1) * 1.4, (j - 1) * 1.4, 0], np.float32)
            t.rotation = np.array([10.0, 25.0 + 7.0 * i, 0.0], np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh))
            reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0, 5.2])
    r.editor_camera.look_at_target([0, 0, 0])
    r.editor_camera.set_viewport_size(W, H)
    packed = r.geometry.packed()
    records = gather_mesh_draws(reg, r.geometry)
    plan, tri_draw = r._plan_cache.plan(packed, records, r.geometry.version)
    params, _pal, shade = build_draw_params(
        records, plan.num_draws, material_table=r.geometry.material_table())
    return (params, shade, r.editor_camera.params(),
            r._plan_cache.corner_table(packed), tri_draw, plan.tri_valid,
            r.textures.device_arrays().sizes)


def _port_fused(fields, cols):
    """The port's fused pass (plain on the CPU) on the JAX setup/records."""
    ps = from_numpy(JTriangleSetup(**fields), "cpu")
    bins = raster.build_bins(ps, W, H)
    assert bins.aux.tolist() == [0, 0]
    records = records_from_reference(cols)
    return bins, records, resolve.fused_visibility_resolve(
        bins, records, NTX, NTX * NTY)


@pytest.fixture(scope="module")
def jax_side():
    return _jax_fused()


def _image(tiles: np.ndarray) -> np.ndarray:
    """(n_tiles, 1024) → (H, W)."""
    return tiles.reshape(NTY, NTX, raster.TILE, raster.TILE) \
        .transpose(0, 2, 1, 3).reshape(H, W)


def test_fused_matches_jax_fused(jax_side):
    from test_torch_raster import _classify

    fields, cols, jd, jt, ja = jax_side
    _bins, _rec, (pd, pt, pa) = _port_fused(fields, cols)
    pd, pt, pa = pd.numpy(), pt.numpy(), pa.numpy()
    covered = pt >= 0
    assert covered.sum() > 3000
    ps = from_numpy(JTriangleSetup(**fields), "cpu")
    n_bad = _classify(ps, _image(pt), _image(jt))
    assert n_bad <= max(2, int(covered.sum()) // 1000), n_bad
    same = pt == jt
    assert np.abs(pd - jd)[same].max() <= 1e-6
    assert (pa.transpose(0, 2, 1)[~covered] == 0).all()
    assert (ja.transpose(0, 2, 1)[jt < 0] == 0).all()
    both = same & covered
    p = pa.transpose(0, 2, 1)[both]                        # (N, 16)
    j = ja.transpose(0, 2, 1)[both]
    exact = list(range(resolve.CH_CF, resolve.CHANNELS))
    assert (p[:, exact] == j[:, exact]).all()
    for ch in range(resolve.CH_NX, resolve.CH_V + 1):
        err = np.abs(p[:, ch] - j[:, ch]) / np.maximum(1.0, np.abs(j[:, ch]))
        assert err.max() <= 5e-5, (ch, err.max())
    mip = resolve.CH_MIP
    assert np.abs(p[:, mip] - j[:, mip]).max() <= 1e-4


def test_fused_bitwise_vs_jax_without_fma(tmp_path):
    dst = tmp_path / "fused.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, __file__, str(dst)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(dst)
    fields = {f: out[f"setup_{f}"] for f in JTriangleSetup._fields}
    _bins, _rec, (pd, pt, pa) = _port_fused(fields, out["cols"])
    pt, pd = pt.numpy(), pd.numpy()
    assert (pt == out["tri"]).all()
    assert (pd.view(np.int32) == out["depth"].view(np.int32)).all()
    covered = pt >= 0
    p = pa.numpy().transpose(0, 2, 1)[covered].view(np.int32).astype(np.int64)
    j = out["attrs"].transpose(0, 2, 1)[covered].view(np.int32) \
        .astype(np.int64)
    mip = resolve.CH_MIP
    others = [ch for ch in range(resolve.CHANNELS) if ch != mip]
    assert (p[:, others] == j[:, others]).all()
    assert np.abs(p[:, mip] - j[:, mip]).max() <= 1


def test_fused_equals_split_path_bitwise(jax_side):
    """fused = visibility then resolve: the same depth and ids, and the
    tiled attributes equal the (H, W) resolve's, permuted; the tiled
    resolve's plain version is that permutation too."""
    fields, cols, *_ = jax_side
    bins, records, (fd, ft, fa) = _port_fused(fields, cols)
    d, t = raster.visibility_tiles(bins, NTX, NTX * NTY)
    assert (ft == t).all()
    assert (fd.view(torch.int32) == d.view(torch.int32)).all()
    tiled = resolve.resolve_attrs_tiled(t, records, NTX)
    assert (tiled.view(torch.int32) == fa.view(torch.int32)).all()
    hw = resolve.resolve_attrs(
        raster.untile_frame(t, NTX, NTY).contiguous(), records)
    back = raster.untile_channels(fa, NTX, NTY)
    assert back.shape == hw.shape == (H, W, resolve.CHANNELS)
    assert (back.view(torch.int32) == hw.view(torch.int32)).all()
    assert resolve.fused_visibility_resolve.launches == 0   # CPU: plain


def test_fused_region_schedule_equals_plain(jax_side):
    """The fused kernel's schedule: the region merge (each warp only the
    staged rows the region test keeps for its 16×8 region), then the tiled
    resolve of its winners, equals fused_visibility_resolve_plain — ids
    and depths bit-equal, attributes exact."""
    from test_torch_vis_region import _region_merge

    fields, cols, *_ = jax_side
    bins, records, _out = _port_fused(fields, cols)
    (depth, tri), kept, tested = _region_merge(bins, NTX, NTX * NTY, False)
    attrs = resolve.resolve_attrs_tiled_plain(tri, records, NTX)
    fd, ft, fa = resolve.fused_visibility_resolve_plain(bins, records, NTX,
                                                        NTX * NTY)
    assert 0 < kept < tested and int((tri >= 0).sum()) > 3000
    assert torch.equal(tri, ft)
    assert (depth.view(torch.int32) == fd.view(torch.int32)).all()
    assert (attrs.view(torch.int32) == fa.view(torch.int32)).all()


if __name__ == "__main__":
    fields, cols, depth, tri, attrs = _jax_fused()
    np.savez(sys.argv[1], cols=cols, depth=depth, tri=tri, attrs=attrs,
             **{f"setup_{k}": v for k, v in fields.items()})
