"""Port attribute resolve vs the JAX package's resolve kernel (interpret
mode) over the same winners and the same records.

The JAX side runs one jit: draw rows → corner stage → records →
visibility_pallas_tiled → resolve_attrs_pallas, on a 3×3 sphere grid at
128². The port resolves the JAX winner map against the JAX (RW, T) record
columns, carried across as its (T, RW) rows (records_from_reference).
Per-channel tolerances:
  * in a child process whose XLA:CPU may not emit FMAs
    (--xla_cpu_max_isa=AVX), every channel is bit-equal except the mip
    level, ½·log2 of the derivative footprint, which may differ by one ulp
    because XLA's log2 and PyTorch's are different approximations; no
    pixel's rounded mip level flips;
  * in this process XLA:CPU contracts the plane evaluations into FMAs:
    the material, texture and colour channels are copies of record rows
    and still match exactly; normal and UV agree to 5e-5 relative to
    max(1, |value|); the mip level to 1e-4 absolute.
Run as a script, this file is the child: `python test_torch_resolve.py
OUT.npz` writes the JAX side's records, winners and attributes.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from trident_tpu.core.config import EngineConfig, RenderConfig
from trident_tpu.ecs import (
    MeshComponent,
    Registry,
    TextureComponent,
    TransformComponent,
)
from trident_tpu.geometry.primitives import PrimitiveType
from trident_tpu.io.image import checkerboard
from trident_tpu.ops import planes as jplanes
from trident_tpu.ops import raster_pallas as jrp
from trident_tpu.ops import resolve_pallas as jrsp
from trident_tpu.ops.corner import build_draw_rows, corner_stage
from trident_tpu.render.frame import build_draw_params, gather_mesh_draws
from trident_tpu.render.renderer import Renderer

from trident_tpu_torch.ops import resolve
from trident_tpu_torch.ops.planes import records_from_reference

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
W = H = 128


def _jax_resolve():
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
    tex = r.textures.device_arrays()

    def run(params, shade, cam, corner_t, tri_draw, valid, sizes):
        tex_row = sizes[params.texture_slot].astype(jnp.float32)
        draw_rows = build_draw_rows(
            params, cam, W, H,
            draw_consts=jnp.concatenate([shade, tex_row], axis=1))
        cs = corner_stage(corner_t, draw_rows, tri_draw, valid, W, H)
        cols = jplanes.build_resolve_cols_planar(cs.cols)
        bins, _d, tri_t, _w = jrp.visibility_pallas_tiled(
            cs.setup, W, H, interpret=True, setup_cols=cs.cols.setup)
        attrs = jrsp.resolve_attrs_pallas(
            bins, tri_t, jplanes.chunk_resolve_cols(cols, jrp.CHUNK), W, H,
            interpret=True)
        tri = jrp.untile_frame(tri_t, W // jrp.TILE_W, H // jrp.TILE_H)
        return cols, tri[:H, :W], attrs

    out = jax.jit(run)(params, shade, r.editor_camera.params(),
                       r._plan_cache.corner_table(packed), tri_draw,
                       plan.tri_valid, tex.sizes)
    return [np.array(a) for a in out]


def test_resolve_matches_pallas_per_channel():
    cols, tri, jattrs = _jax_resolve()
    covered = tri >= 0
    assert covered.sum() > 3000
    pattrs = resolve.resolve_attrs(torch.from_numpy(tri),
                                   records_from_reference(cols)).numpy()
    assert (pattrs[~covered] == 0).all() and (jattrs[~covered] == 0).all()
    p, j = pattrs[covered], jattrs[covered]
    exact = list(range(resolve.CH_CF, resolve.CHANNELS))
    assert (p[:, exact] == j[:, exact]).all()
    for ch in range(resolve.CH_NX, resolve.CH_V + 1):
        err = np.abs(p[:, ch] - j[:, ch]) / np.maximum(1.0, np.abs(j[:, ch]))
        assert err.max() <= 5e-5, (ch, err.max())
    mip = resolve.CH_MIP
    assert np.abs(p[:, mip] - j[:, mip]).max() <= 1e-4
    # the wrapper on CPU tensors is the plain version
    plain = resolve.resolve_attrs_plain(torch.from_numpy(tri),
                                        records_from_reference(cols)).numpy()
    assert (plain == pattrs).all()


def test_resolve_bitwise_vs_pallas_without_fma(tmp_path):
    dst = tmp_path / "resolve.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, __file__, str(dst)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(dst)
    cols, tri, jattrs = out["cols"], out["tri"], out["attrs"]
    covered = tri >= 0
    assert covered.sum() > 3000
    pattrs = resolve.resolve_attrs(torch.from_numpy(tri),
                                   records_from_reference(cols)).numpy()
    assert (pattrs[~covered] == 0).all() and (jattrs[~covered] == 0).all()
    p = pattrs[covered].view(np.int32).astype(np.int64)
    j = jattrs[covered].view(np.int32).astype(np.int64)
    mip = resolve.CH_MIP
    others = [ch for ch in range(resolve.CHANNELS) if ch != mip]
    assert (p[:, others] == j[:, others]).all()
    assert np.abs(p[:, mip] - j[:, mip]).max() <= 1
    max_level = 7.0                          # the 128² checker's pyramid
    level = [np.round(np.clip(a[covered][:, mip], 0.0, max_level))
             for a in (pattrs, jattrs)]
    assert (level[0] == level[1]).all()


def test_eval_interpolants_reference_expressions():
    """eval_interpolants against a float64 evaluation of the same rational
    forms: normal/UV = (g·p)/(g1·p), mip = ½·log2 of the UV footprint."""
    rng = np.random.default_rng(2)
    n = 500
    sel = rng.standard_normal((resolve.P.RR_WIDTH, n)).astype(np.float32)
    sel[resolve.P.RR_G1 + 2] = 50.0 + rng.uniform(0, 10, n)    # g1·p ≫ 0
    sel[resolve.P.RR_TSX:resolve.P.RR_TSY + 1] = 64.0
    px = rng.uniform(0, 64, n).astype(np.float32)
    py = rng.uniform(0, 64, n).astype(np.float32)
    out = resolve.eval_interpolants(torch.from_numpy(sel),
                                    torch.from_numpy(px),
                                    torch.from_numpy(py)).numpy()
    s = sel.astype(np.float64)

    def plane(j):
        return s[j] * px + s[j + 1] * py + s[j + 2]

    inv = 1.0 / plane(0)
    u, v = plane(12) * inv, plane(15) * inv
    np.testing.assert_allclose(out[resolve.CH_NX], plane(3) * inv, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out[resolve.CH_U], u, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[resolve.CH_V], v, rtol=1e-4, atol=1e-5)
    dudx, dudy = (s[12] - u * s[0]) * inv, (s[13] - u * s[1]) * inv
    dvdx, dvdy = (s[15] - v * s[0]) * inv, (s[16] - v * s[1]) * inv
    rho = np.maximum((dudx * 64) ** 2 + (dvdx * 64) ** 2,
                     (dudy * 64) ** 2 + (dvdy * 64) ** 2)
    np.testing.assert_allclose(out[resolve.CH_MIP],
                               0.5 * np.log2(np.maximum(rho, 1e-12)),
                               atol=2e-4)


if __name__ == "__main__":
    cols, tri, attrs = _jax_resolve()
    np.savez(sys.argv[1], cols=cols, tri=tri, attrs=attrs)
