"""The port's kbench probes (trident_tpu_torch/tools_dev/kbench.py) against
the JAX package's visibility kernel on a small carried-across kbench scene.

The scene is kbench's sphere grid (scripts/profile_stages.py::build_scene's
layout) at 4×4 and 128², built on the JAX package at chip_smoke.py's
phase-3 rotation and carried across with `from_reference`
(test_torch_host.py::carry_renderer); the port bins it as kbench does
(frame_inputs → frame_geometry → build_bins). The JAX kernel
(`visibility_pallas`, interpret mode) runs on the port's triangle setup in
a child process whose XLA:CPU may not emit FMAs (--xla_cpu_max_isa=AVX),
as test_torch_raster.py runs it, so it rounds every product and sum once,
as the port does. Every comparison is exact: on the CPU each probe wrapper
takes its plain version, and
  * dflt, full, nobranch and dual give the JAX dflt winners, ids equal and
    depths bit-equal (dual's strip table is zeros; full and nobranch also
    evaluate the sub-blocks the binner left out, and in this scene none of
    their triangles passes the cover test at a pixel of the tile — at
    spheres1080_1m 55 pixels on the extension lines of near-degenerate
    triangles do, which bbox_culled_hits classifies);
  * zero, probe and probe_tiny give background (depth 1, id −1);
  * under ckern the bank table rebuilt from the doctored masks gives the
    compact-bank kernel's plain version the same frames.
Run as a script, this file is the child: `python test_torch_kbench.py
SETUP.npz OUT.npz` runs the JAX kernel on SETUP's triangles.
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

from trident_tpu.ops.raster_pallas import visibility_pallas
from trident_tpu.ops.vertex import TriangleSetup as JTriangleSetup

from trident_tpu_torch import _build
from trident_tpu_torch.ops import planes, raster
from trident_tpu_torch.tools_dev import diag_split_kernel, gather_probe
from trident_tpu_torch.tools_dev import kbench as kb
from trident_tpu_torch.tools_dev.scenes import build_bench_scene, rotate

from test_torch_host import carry_renderer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
W = H = 128
GRID = 4
NTX = NTY = W // raster.TILE
N_TILES = NTX * NTY
BACKGROUND = ("zero", "probe", "probe_tiny")


def _jax_kbench_scene():
    """kbench's sphere grid on the JAX package at GRID × GRID and W × H,
    rotated as chip_smoke.py's phase 3 renders it (rotate(reg, 0))."""
    from trident_tpu.core.config import EngineConfig, RenderConfig
    from trident_tpu.ecs import (
        MeshComponent,
        Registry,
        TextureComponent,
        TransformComponent,
    )
    from trident_tpu.geometry.primitives import PrimitiveType
    from trident_tpu.io.image import checkerboard
    from trident_tpu.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(width=W, height=H,
                                                  use_pallas=True)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    mesh = r.ensure_primitive(PrimitiveType.SPHERE)
    for i in range(GRID):
        for j in range(GRID):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array([(i - GRID / 2) * 1.4,
                                   (j - GRID / 2) * 1.4, 0], np.float32)
            t.rotation = np.array([25.0 * 0.4, 25.0, 0.0], np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh))
            reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0, GRID * 1.1 + 2])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def _image(tiles: torch.Tensor) -> np.ndarray:
    return raster.untile_frame(tiles, NTX, NTY)[:H, :W].numpy()


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    """The port's (cs, bins) of the carried scene and the JAX kernel's
    (tri_id, depth) on its triangles, from the no-FMA child."""
    tr = carry_renderer(_jax_kbench_scene())
    cs, _records, bins, w, h = kb.frame_bins(tr)
    assert (w, h) == (W, H) and bins.aux.tolist() == [0, 0]
    tmp = tmp_path_factory.mktemp("kbench")
    src, dst = tmp / "setup.npz", tmp / "vis.npz"
    np.savez(src, **{f: getattr(cs.setup, f).numpy()
                     for f in JTriangleSetup._fields})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, __file__, str(src), str(dst)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(dst)
    assert out["aux"].tolist() == [0, 0]
    return cs, bins, out["tri_id"], out["depth"]


def _assert_frame(depth, tri, jt, jd, kind):
    pt, pd = _image(tri), _image(depth)
    if kind in BACKGROUND:
        assert (pt == -1).all() and (pd == 1.0).all(), kind
        return
    assert (pt == jt).all(), (kind, int((pt != jt).sum()))
    assert (pd.view(np.int32) == jd.view(np.int32)).all(), kind


@pytest.mark.parametrize("kind", kb.CONFIGS)
def test_config_matches_jax_k1(side, kind):
    """Each config on the CPU (the wrappers take their plain versions)
    against the JAX kernel's dflt frame, or background."""
    _cs, bins, jt, jd = side
    assert int((jt >= 0).sum()) > 2000
    launches = dict(_build.LAUNCHES)
    depth, tri = kb.config_fn(bins, kind, NTX, N_TILES)()
    _assert_frame(depth, tri, jt, jd, kind)
    plain = kb.config_fn(bins, kind, NTX, N_TILES, plain=True)()
    assert (plain[1] == tri).all()
    assert (plain[0].view(torch.int32) == depth.view(torch.int32)).all()
    assert dict(_build.LAUNCHES) == launches


@pytest.mark.parametrize("kind", ("zero", "dflt", "full"))
def test_ckern_configs_match_jax_k1(side, kind):
    """--kernel ckern: the bank table rebuilt from the doctored masks; the
    compact-bank kernel's plain version gives the same frames."""
    cs, _bins, jt, jd = side
    ckb = raster.build_bins(cs.setup, W, H, setup_cols=cs.cols.setup,
                            ck_bank=kb.CK_BANK)
    b = kb.doctored(ckb, kind, kb.CK_BANK)
    n = int(b.n_real)
    want = {"zero": 0, "dflt": None, "full": raster.NSUB}[kind]
    if want is not None:
        assert (b.nhit[:n] == want).all() and (b.nhit[n:] == 0).all()
    depth, tri = kb.config_fn(ckb, kind, NTX, N_TILES, kb.CK_BANK)()
    _assert_frame(depth, tri, jt, jd, kind)


def _jax_doctored_words(real: np.ndarray, kind: str):
    """kbench.py:107-112 (the hit-mask layout, no DYNHIT), with the port's
    one-word 16-bit mask: MASK_WORDS = 1, MASK_BITS = NSUB."""
    mask_words, mask_bits = 1, raster.NSUB
    hit_words = mask_bits - 30 * (mask_words - 1)
    words = []
    for wd in range(mask_words):
        bits = 30 if wd < mask_words - 1 else hit_words
        val = (1 << bits) - 1 if kind == "full" else 0
        words.append(np.where(real, val, 0).astype(np.int32))
    return words


def test_doctored_masks(side):
    _cs, bins, _jt, _jd = side
    n = int(bins.n_real)
    real = np.arange(bins.pair_mask.shape[0]) < n
    assert kb.doctored(bins, "dflt") is bins
    for kind in ("zero", "full"):
        b = kb.doctored(bins, kind)
        mask = b.pair_mask.numpy()
        assert b.pair_mask.dtype == torch.int32
        assert (mask[n:] == 0).all()                 # padding stays 0
        assert (mask == _jax_doctored_words(real, kind)[0]).all()
        for f in ("records", "pair_tile", "pair_chunk", "tile_start"):
            assert getattr(b, f) is getattr(bins, f)
    assert kb.hit_total(kb.doctored(bins, "full")) == n * raster.NSUB
    assert 0 < kb.hit_total(bins) < n * raster.NSUB
    with pytest.raises(ValueError):
        kb.doctored(bins, "half")


def test_bbox_culled_hits_classifies_differences():
    """A differing pixel is explained only when its winner's bbox excludes
    it and the winner beats the binned one; equal frames have none."""
    from types import SimpleNamespace

    setup = SimpleNamespace(bbox=torch.tensor(
        [[0, 0, 4, 4], [40, 0, 48, 8], [30, 0, 40, 8]], dtype=torch.int32))
    ref_d = torch.ones((2, raster.TILE_PX))
    ref_t = torch.full((2, raster.TILE_PX), -1, dtype=torch.int32)
    assert kb.bbox_culled_hits(setup, ref_d, ref_t, ref_d, ref_t, 2) == (0, 0)
    d, t = ref_d.clone(), ref_t.clone()
    d[1, 3], t[1, 3] = 0.5, 2          # pixel (35, 0): inside bbox 2
    d[1, 5], t[1, 5] = 0.5, 0          # pixel (37, 0): outside bbox 0
    assert kb.bbox_culled_hits(setup, d, t, ref_d, ref_t, 2) == (2, 1)
    d[1, 3], t[1, 3] = 0.5, 1          # pixel (35, 0): outside bbox 1
    assert kb.bbox_culled_hits(setup, d, t, ref_d, ref_t, 2) == (2, 0)
    # a winner that does not beat the binned one is no rounding hit
    assert kb.bbox_culled_hits(setup, ref_d, ref_t, d, t, 2) == (2, 2)


def test_kbench_cli_on_cpu(capsys):
    """The tool end to end with --device cpu: the plain versions, no
    timing; the binning and sort legs run once."""
    kb.main(["--device", "cpu", "--grid", "1", "--configs",
             "zero,dflt,probe_tiny", "--iters", "1", "--bins", "--sort"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device=cpu grid=1 1920x1080")
    assert out[1].startswith("pairs=") and "aux=[0, 0]" in out[1]
    kinds = [line.split(":")[0] for line in out if line.startswith("kind=")]
    assert kinds == ["kind=zero", "kind=dflt", "kind=probe_tiny"]
    for label in ("build_bins", "records_only", "bins_minus_records",
                  "build_bins(full outputs)", "sort_131072"):
        assert any(line.startswith(label + ":") for line in out), label
    assert all("not measured" in line for line in out[2:-1])
    assert out[-1] == "cpu"


def test_kbench_records_leg_on_cpu(capsys):
    """--records on the CPU: both producers run in the order rows,
    columns, columns, rows, untimed; the column table is the row table
    transposed, bit for bit, so the A/B compares one function."""
    kb.main(["--device", "cpu", "--grid", "1", "--configs", "zero",
             "--iters", "1", "--records"])
    out = capsys.readouterr().out.splitlines()
    legs = [line.split(":")[0] for line in out
            if line.startswith("records_")]
    assert legs == ["records_rows", "records_columns", "records_columns",
                    "records_rows"]
    assert all("not measured" in line for line in out[2:-1])
    from trident_tpu_torch.render import renderer
    assert (renderer.build_resolve_cols_planar
            is planes.build_resolve_cols_planar)
    r, reg = build_bench_scene(1, torch.device("cpu"))
    rotate(reg, 0)
    cs = kb.frame_bins(r)[0]
    rows = planes.build_resolve_cols_planar(cs.cols)
    cols = kb.records_columns(cs.cols)
    assert cols.shape == (planes.RR_WIDTH, rows.shape[0])
    assert torch.equal(cols.T.view(torch.int32), rows.view(torch.int32))


@pytest.mark.parametrize("tool", (kb, gather_probe, diag_split_kernel))
def test_tools_raise_without_card(monkeypatch, tool):
    """Each tool runs on the card unless --device cpu is passed; without a
    card it raises instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([])


if __name__ == "__main__":
    setup_npz, out_npz = sys.argv[1:]
    arrays = np.load(setup_npz)
    setup = JTriangleSetup(**{f: jnp.asarray(arrays[f])
                              for f in JTriangleSetup._fields})
    g = jax.jit(lambda s: visibility_pallas(s, W, H, interpret=True))(setup)
    np.savez(out_npz, tri_id=np.asarray(g.tri_id),
             depth=np.asarray(g.depth), aux=np.asarray(g.aux))
