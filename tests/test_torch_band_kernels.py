"""The band-offset branches of the port's kernels (their plain versions,
which the wrappers run on CPU tensors) against the JAX package's kernels
run under interpret=True with the same tile_y_offset on a band-sliced
setup, and against the port's own full-frame results on the band's rows.

A band of a taller frame keeps the full frame's edge functions, z and w
and only its bboxes move band-local (band_slice_setup); the kernels add
the band's first tile row back, so each band's rows must be the full
frame's. Scenes: test_torch_fused.py's 3×3 sphere grid at 128² and
test_torch_vcolor.py's vertex-coloured one, split into two 64-row bands
(tile offsets 0 and 2; one jit per kernel set, the band's offset traced).

Tolerances, with their reasons (those of test_torch_fused.py and
test_torch_vcolor.py for the same kernels without an offset):
  * band_slice_setup: bit-equal (integer bboxes, the same mask);
  * in this process XLA:CPU contracts the interpreted kernels' edge
    functions and plane evaluations into FMAs, so winner ids may differ
    only at mismatches test_torch_raster.py classifies (depth ties within
    2 ulps or edge flips), at most max(2, covered / 1000) of them; where
    the ids agree depth is within 1e-6 and the attributes within
    test_torch_vcolor.py's _check_attrs (copied channels exact, normal,
    UV and colour within 5e-5 relative to max(1, |value|), mip 1e-4);
  * against the port's own full frame (the same per-op rounding): bit for
    bit, ids, depths and attributes.
The kernel comparisons cut the bands as the JAX package does
(band_slice_setup with cull=True, on both sides). The banded frame cuts
with cull=False, and its bins are then exactly the full frame's pairs on
the band's rows (the last test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ops import kernel_knobs as jknobs
from trident_tpu.ops import planes as jplanes
from trident_tpu.ops import raster_pallas as jrp
from trident_tpu.ops import resolve_pallas as jrsp
from trident_tpu.ops.corner import build_draw_rows, corner_stage
from trident_tpu.ops.vertex import TriangleSetup as JTriangleSetup
from trident_tpu.ops.vertex import band_slice_setup as j_band_slice

from trident_tpu_torch import _build
from trident_tpu_torch.ops import raster, resolve
from trident_tpu_torch.ops.planes import records_from_reference
from trident_tpu_torch.ops.vertex import TriangleSetup, band_slice_setup
from trident_tpu_torch.render.types import from_numpy

from test_torch_fused import _scene_inputs
from test_torch_raster import _classify
from test_torch_vcolor import _check_attrs
from test_torch_vcolor import _scene_inputs as _vc_scene_inputs

torch.set_num_threads(1)

W = H = 128
BH = 64                                  # two bands
NTX = W // raster.TILE
NTB = BH // raster.TILE                  # tile rows per band
BANDS = (0, 1)


def test_band_slice_setup_bit_equal_to_jax():
    """Random bboxes (some outside the frame's rows, some empty) and
    offsets: the port's band cut equals the JAX one bit for bit."""
    rng = np.random.default_rng(7)
    t = 257
    y0s = rng.integers(-8, 140, t)
    ys = np.sort(rng.integers(-20, 160, (t, 2)), axis=1)
    xs = np.sort(rng.integers(0, 128, (t, 2)), axis=1)
    bbox = np.stack([xs[:, 0], ys[:, 0], xs[:, 1], ys[:, 1]], 1) \
        .astype(np.int32)
    fields = dict(edge=rng.standard_normal((t, 3, 3)).astype(np.float32),
                  z=rng.random((t, 3), np.float32),
                  w=rng.random((t, 3), np.float32) + 0.5, bbox=bbox,
                  valid=rng.random(t) < 0.8)
    js = JTriangleSetup(**{k: jnp.asarray(v) for k, v in fields.items()})
    ps = TriangleSetup(**{k: torch.from_numpy(v) for k, v in fields.items()})
    for y0, band_h in ((0, 32), (32, 32), (64, 64), (96, 32),
                       (int(y0s[0]), 17)):
        j = j_band_slice(js, y0, band_h)
        p = band_slice_setup(ps, y0, band_h)
        for f in JTriangleSetup._fields:
            a, b = np.asarray(getattr(j, f)), getattr(p, f).numpy()
            assert a.dtype == b.dtype and (a == b).all(), (y0, band_h, f)
    assert band_slice_setup(ps, 64, 64).valid.sum() < ps.valid.sum()


def _jax_bands(inputs, vertex_colors: bool, ckern: bool = False):
    """The JAX side for each band: the full-frame setup and record
    columns, and per band the band kernels' outputs (numpy). One jit; the
    band's first row is a traced argument. `ckern` runs the compact-bank
    visibility alone, under kernel_knobs.overrides(ckern=True,
    dynhit=False)."""
    def run(params, shade, cam, corner_t, tri_draw, valid, sizes, y0):
        tex_row = sizes[params.texture_slot].astype(jnp.float32)
        rows = build_draw_rows(
            params, cam, W, H,
            draw_consts=jnp.concatenate([shade, tex_row], axis=1))
        cs = corner_stage(corner_t, rows, tri_draw, valid, W, H,
                          vertex_colors=vertex_colors)
        cols = jplanes.build_resolve_cols_planar(cs.cols)
        rec = jplanes.chunk_resolve_cols(cols, jrp.CHUNK)
        band = j_band_slice(cs.setup, y0, BH)
        ty = y0 // jrp.TILE_H
        bins, depth, tri_t, _w = jrp.visibility_pallas_tiled(
            band, W, BH, interpret=True, tile_y_offset=ty,
            setup_cols=cs.cols.setup)
        out = dict(depth=depth[:, 0], tri_t=tri_t[:, 0])
        if ckern:
            return cs.setup, cols, out
        _b, dd, _t, _w = jrp.visibility_pallas_tiled(
            band, W, BH, interpret=True, tile_y_offset=ty,
            setup_cols=cs.cols.setup, depth_only=True)
        out["depth_only"] = dd[:, 0]
        out["attrs"] = jrsp.resolve_attrs_pallas(
            bins, tri_t, rec, W, BH, vertex_colors=vertex_colors,
            interpret=True, tile_y_offset=ty)
        out["attrs_t"] = jrsp.resolve_attrs_pallas(
            bins, tri_t, rec, W, BH, vertex_colors=vertex_colors,
            interpret=True, tile_y_offset=ty, tiled=True)
        _b, fd, ft, fa, _w = jrsp.fused_visibility_resolve_pallas(
            band, rec, W, BH, vertex_colors=vertex_colors, interpret=True,
            tile_y_offset=ty, setup_cols=cs.cols.setup)
        out.update(fdepth=fd[:, 0], ftri=ft[:, 0], fattrs=fa)
        return cs.setup, cols, out

    fn = jax.jit(run)
    bands = []
    for b in BANDS:
        if ckern:
            with jknobs.overrides(ckern=True, dynhit=False):
                setup, cols, out = fn(*inputs, jnp.int32(b * BH))
        else:
            setup, cols, out = fn(*inputs, jnp.int32(b * BH))
        bands.append({k: np.array(v) for k, v in out.items()})
    fields = {f: np.array(getattr(setup, f)) for f in setup._fields}
    return fields, np.array(cols), bands


@pytest.fixture(scope="module")
def plain_side():
    return _jax_bands(_scene_inputs(), False)


@pytest.fixture(scope="module")
def vc_side():
    return _jax_bands(_vc_scene_inputs(), True)


def _image(tiles: np.ndarray, rows: int) -> np.ndarray:
    """(n_tiles, 1024) → (rows, W)."""
    nty = rows // raster.TILE
    return tiles.reshape(nty, NTX, raster.TILE, raster.TILE) \
        .transpose(0, 2, 1, 3).reshape(rows, W)


def _in_frame(band_ids: np.ndarray, b: int) -> np.ndarray:
    """A band's (BH, W) ids placed at its rows of a (H, W) frame of −1."""
    full = np.full((H, W), -1, np.int32)
    full[b * BH:(b + 1) * BH] = band_ids
    return full


def _port_full(ps: TriangleSetup):
    """The port's one-device visibility of the whole frame (plain)."""
    bins = raster.build_bins(ps, W, H)
    depth, tri = raster.visibility_tiles(bins, NTX, NTX * (H // raster.TILE))
    return bins, depth, tri


def _band_bins(ps: TriangleSetup, b: int, **kw):
    bins = raster.build_bins(band_slice_setup(ps, b * BH, BH), W, BH, **kw)
    assert bins.aux.tolist() == [0, 0]
    return bins


def _check_ids(ps, pt, jt, b):
    """Port band ids pt against the JAX band ids jt (tile layout): the
    classified FMA mismatches only."""
    pi, ji = _image(pt, BH), _image(jt, BH)
    covered = int((pi >= 0).sum())
    n_bad = _classify(ps, _in_frame(pi, b), _in_frame(ji, b))
    assert n_bad <= max(2, covered // 1000), n_bad
    return pt == jt


@pytest.mark.parametrize("b", BANDS)
def test_band_visibility_matches_jax_and_the_full_frame(plain_side, b):
    """K1's and K1b's band branches (plain) against the JAX band kernel,
    colour and depth-only, and against the port's full frame's rows."""
    fields, _cols, bands = plain_side
    jb = bands[b]
    ps = from_numpy(JTriangleSetup(**fields), "cpu")
    bins = _band_bins(ps, b)
    depth, tri = raster.visibility_tiles(bins, NTX, NTX * NTB,
                                         tile_y_offset=b * NTB)
    assert int((tri >= 0).sum()) > 1500
    same = _check_ids(ps, tri.numpy(), jb["tri_t"], b)
    assert np.abs(depth.numpy() - jb["depth"])[same].max() <= 1e-6
    dd = raster.visibility_tiles(bins, NTX, NTX * NTB, depth_only=True,
                                 tile_y_offset=b * NTB)
    assert torch.equal(dd.view(torch.int32), depth.view(torch.int32))
    assert np.abs(dd.numpy() - jb["depth_only"])[same].max() <= 1e-6
    # the port's full frame, on the band's rows: bit for bit
    _fb, fdepth, ftri = _port_full(ps)
    rows = slice(b * NTB * NTX, (b + 1) * NTB * NTX)
    assert torch.equal(tri, ftri[rows])
    assert torch.equal(depth.view(torch.int32), fdepth[rows].view(torch.int32))
    # without the offset the band would sit at the frame's top
    if b:
        _d0, t0 = raster.visibility_tiles(bins, NTX, NTX * NTB)
        assert not torch.equal(t0, tri)


@pytest.mark.parametrize("b", BANDS)
def test_band_ckern_matches_jax_ckern_and_default(b):
    """K1-CK's band branch (plain, the TPU bank schedule) against the JAX
    CKERN kernel with the same offset, and bit-equal to the band's default
    visibility."""
    fields, _cols, bands = _ck_side()
    ps = from_numpy(JTriangleSetup(**fields), "cpu")
    bins = _band_bins(ps, b, ck_bank=8)
    depth, tri = raster.visibility_ck_tiles(bins, NTX, NTX * NTB, 8,
                                            tile_y_offset=b * NTB)
    d0, t0 = raster.visibility_tiles(_band_bins(ps, b), NTX, NTX * NTB,
                                     tile_y_offset=b * NTB)
    assert torch.equal(tri, t0)
    assert torch.equal(depth.view(torch.int32), d0.view(torch.int32))
    same = _check_ids(ps, tri.numpy(), bands[b]["tri_t"], b)
    assert np.abs(depth.numpy() - bands[b]["depth"])[same].max() <= 1e-6


_CK = {}


def _ck_side():
    if "side" not in _CK:
        _CK["side"] = _jax_bands(_scene_inputs(), False, ckern=True)
    return _CK["side"]


def _resolve_checks(side, b):
    """K2 and tiled K2 (the table's width picks the instance) on the JAX
    band winners: against the JAX band resolve, and the band's rows of the
    port's full-frame resolve bit for bit."""
    fields, cols, bands = side
    jb = bands[b]
    records = records_from_reference(cols)
    tri_t = torch.from_numpy(jb["tri_t"])
    tri = torch.from_numpy(_image(jb["tri_t"], BH).copy())
    covered = tri.numpy() >= 0
    p = resolve.resolve_attrs(tri, records, y_offset=b * BH).numpy()
    _check_attrs(p.reshape(-1, 16), jb["attrs"].reshape(-1, 16),
                 covered.reshape(-1))
    pt = resolve.resolve_attrs_tiled(tri_t, records, NTX,
                                     tile_y_offset=b * NTB).numpy()
    _check_attrs(pt.transpose(0, 2, 1).reshape(-1, 16),
                 jb["attrs_t"].transpose(0, 2, 1).reshape(-1, 16),
                 jb["tri_t"].reshape(-1) >= 0)
    # the band's rows of a full-frame id map resolved without an offset
    full = torch.full((H, W), -1, dtype=torch.int32)
    full[b * BH:(b + 1) * BH] = tri
    pf = resolve.resolve_attrs(full, records).numpy()[b * BH:(b + 1) * BH]
    assert (p.view(np.int32) == pf.view(np.int32)).all()
    full_t = torch.full((NTX * NTX, raster.TILE_PX), -1, dtype=torch.int32)
    full_t[b * NTB * NTX:(b + 1) * NTB * NTX] = tri_t
    pft = resolve.resolve_attrs_tiled(full_t, records, NTX).numpy()
    assert (pt.view(np.int32)
            == pft[b * NTB * NTX:(b + 1) * NTB * NTX].view(np.int32)).all()
    return records


def _fused_checks(side, b, records):
    """K-FUSE's band branch (plain) on the band's bins against the JAX
    fused band kernel, and bit-equal to the band's visibility + tiled
    resolve."""
    fields, _cols, bands = side
    jb = bands[b]
    ps = from_numpy(JTriangleSetup(**fields), "cpu")
    bins = _band_bins(ps, b)
    d, t, a = resolve.fused_visibility_resolve(bins, records, NTX,
                                               NTX * NTB,
                                               tile_y_offset=b * NTB)
    d0, t0 = raster.visibility_tiles(bins, NTX, NTX * NTB,
                                     tile_y_offset=b * NTB)
    a0 = resolve.resolve_attrs_tiled(t0, records, NTX, tile_y_offset=b * NTB)
    assert torch.equal(t, t0) and torch.equal(d, d0) and torch.equal(a, a0)
    same = _check_ids(ps, t.numpy(), jb["ftri"], b)
    assert np.abs(d.numpy() - jb["fdepth"])[same].max() <= 1e-6
    covered = t.numpy() >= 0
    keep = ((same & covered) | ~covered).reshape(-1)
    p = a.numpy().transpose(0, 2, 1).reshape(-1, 16)
    j = jb["fattrs"].transpose(0, 2, 1).reshape(-1, 16)
    _check_attrs(p[keep], j[keep], covered.reshape(-1)[keep])


@pytest.mark.parametrize("b", BANDS)
def test_band_resolve_and_fused_match_jax(plain_side, b):
    records = _resolve_checks(plain_side, b)
    _fused_checks(plain_side, b, records)


@pytest.mark.parametrize("b", BANDS)
def test_band_vc_resolve_and_fused_match_jax(vc_side, b):
    """The 40-wide band instances (vertex colours) on the (T, 40) table."""
    records = _resolve_checks(vc_side, b)
    assert records.shape[1] == 40
    _fused_checks(vc_side, b, records)


def test_band_wrappers_count_only_on_the_card():
    """On CPU tensors the visibility and resolve entry points take their
    plain versions with a band's offset, vertex colours and bf16 alike,
    and count no launch."""
    before = dict(_build.LAUNCHES)
    ps = TriangleSetup(edge=torch.zeros(16, 3, 3), z=torch.zeros(16, 3),
                       w=torch.ones(16, 3),
                       bbox=torch.zeros(16, 4, dtype=torch.int32),
                       valid=torch.zeros(16, dtype=torch.bool))
    bins = raster.build_bins(ps, 64, 32, ck_bank=8)
    raster.visibility_tiles(bins, 2, 2, tile_y_offset=3)
    raster.visibility_depth_tiles(bins, 2, 2, tile_y_offset=3)
    raster.visibility_ck_tiles(bins, 2, 2, 8, tile_y_offset=3)
    rec40 = torch.zeros((16, 40))
    ids = torch.full((32, 64), -1, dtype=torch.int32)
    ids_t = torch.full((2, raster.TILE_PX), -1, dtype=torch.int32)
    for prec in ("split", "bf16"):
        resolve.resolve_attrs(ids, rec40, y_offset=96, prec=prec)
        resolve.resolve_attrs_tiled(ids_t, rec40, 2, tile_y_offset=3,
                                    prec=prec)
        resolve.fused_visibility_resolve(bins, rec40, 2, 2, tile_y_offset=3,
                                         prec=prec)
    assert dict(_build.LAUNCHES) == before
    d, t = raster.visibility_tiles(bins, 2, 2, tile_y_offset=3)
    assert (t == -1).all() and (d == 1.0).all()


def _pairs(bins, tile0: int = 0, tiles: int = None) -> set:
    """The kept (tile − tile0, chunk, mask) pairs of `bins` whose tile lies
    in [tile0, tile0 + tiles)."""
    n = int(bins.n_real)
    t = bins.pair_tile[:n].tolist()
    c, m = bins.pair_chunk[:n].tolist(), bins.pair_mask[:n].tolist()
    return {(ti - tile0, ci, mi) for ti, ci, mi in zip(t, c, m)
            if tiles is None or tile0 <= ti < tile0 + tiles}


def test_uncull_band_bins_are_the_full_frames_pairs():
    """The banded frame's cut (band_slice_setup(cull=False)) bins each
    band to exactly the full frame's (tile, chunk, mask) pairs on its
    rows, so its winners are the full frame's by construction; the JAX
    cut (cull=True) drops the out-of-band triangles from the sub-blocks
    that straddle a band, and loses some of those pairs' tiles or bits."""
    from test_torch_raster import SCENES
    from test_torch_raster import H as RH

    (_js, ps), w = SCENES["random"](np.random.default_rng(1234))
    ntx, bh = w // raster.TILE, RH // 2
    full = raster.build_bins(ps, w, RH)
    culled_differs = False
    for b in range(2):
        tiles = ntx * bh // raster.TILE
        want = _pairs(full, b * tiles, tiles)
        assert want
        kept = raster.build_bins(band_slice_setup(ps, b * bh, bh, cull=False),
                                 w, bh)
        assert _pairs(kept) == want
        culled = raster.build_bins(band_slice_setup(ps, b * bh, bh), w, bh)
        culled_differs |= _pairs(culled) != want
    assert culled_differs
