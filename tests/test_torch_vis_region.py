"""The visibility kernel's region test (csrc/visibility_common.cuh
vis_region_bits; its plain twin ops/raster.py region_keep): each warp of
the kernel merges only the staged triangles whose three edge functions are
not all negative over its 16×8 region of the tile, tested at the corner
that maximises each edge, in the kernel's own rounding. The claim is that
the test is exact: a rejected (triangle, region) has no pixel centre that
passes the cover test, so the frame is the full sweep's bit for bit.

(a) a seeded property test over random and near-degenerate edges, slopes
from 1e-8 to 1e8, ±0 slopes, invalid rows and tiles at the frame edge: the
corner value equals the edge's maximum over the region's pixel centres, and
no rejected pair covers a pixel; (b) on the raster tests' scenes the plain
merge restricted to kept pairs equals visibility_tiles_plain bit for bit,
colour and depth-only; (c) the kernel's thread map; (d) the kept share on
a 4×4 bench scene at 1920×1080; and the design-free operation count of
chip_smoke.py's visibility bound (tools_dev/kbench.py bbox_pixel_pairs).
"""

import numpy as np
import pytest
import torch

from trident_tpu_torch.ops import raster
from trident_tpu_torch.tools_dev import kbench

from test_torch_raster import H, SCENES

torch.set_num_threads(1)

NTX, NTY = 60, 34            # 1920×1080 in 32² tiles; the last row overhangs
VIS_THREADS = 256            # the kernel's threads per tile, 4 pixels each


def _thread_map() -> torch.Tensor:
    """(VIS_THREADS, 4) i64: the tile pixel index row·32 + col of thread
    t's k-th pixel, as vis_region_pixel in csrc/visibility_common.cuh maps
    it: warp w = t // 32 owns columns 16·(w % 2) … +15 and rows 8·(w // 2)
    … +7; lane l's k-th pixel is column l % 16 and row 2k + l // 16 of
    that region."""
    t = torch.arange(VIS_THREADS)[:, None]
    k = torch.arange(raster.TILE_PX // VIS_THREADS)
    w, lane = t // 32, t % 32
    return ((raster.REGION_H * (w // 2) + 2 * k + lane // 16) * raster.TILE
            + raster.REGION_W * (w % 2) + lane % 16)


def _pixel_region() -> torch.Tensor:
    """(1024,) i64: the warp region of each tile pixel under the kernel's
    thread map."""
    tmap = _thread_map()
    out = torch.empty(raster.TILE_PX, dtype=torch.int64)
    out[tmap.reshape(-1)] = (torch.arange(VIS_THREADS) // 32)[:, None] \
        .expand_as(tmap).reshape(-1)
    return out


def _random_rows(rng, tiles: np.ndarray) -> np.ndarray:
    """(n, 16, 16) f32 record rows for tiles (n,) whose edges pass near a
    pixel of their tile: slopes of magnitude 10^U(−8, 8) with random
    signs, some ±0, c set so the edge runs through a point near the tile
    (plus an ulp-scale jitter), z and w random; a few rows invalid
    (e ≡ −1), a few with a NaN edge."""
    n = tiles.shape[0]
    rows = np.zeros((n, 16, 16), np.float32)
    x0 = (tiles % NTX * raster.TILE)[:, None] + rng.uniform(-8, 40, (n, 16))
    y0 = (tiles // NTX * raster.TILE)[:, None] + rng.uniform(-8, 40, (n, 16))
    for e in range(3):
        mag = 10.0 ** rng.uniform(-8, 8, (n, 16, 2))
        ab = mag * rng.choice([-1.0, 1.0], (n, 16, 2))
        zero = rng.random((n, 16, 2)) < 0.08
        ab = np.where(zero, rng.choice([0.0, -0.0], (n, 16, 2)), ab)
        rows[:, :, 3 * e:3 * e + 2] = ab
        rows[:, :, 3 * e + 2] = -(ab[..., 0] * x0 + ab[..., 1] * y0)
    ulp = np.spacing(np.abs(rows[:, :, 2:9:3]) + np.float32(1e-30))
    rows[:, :, 2:9:3] += (rng.integers(-3, 4, ulp.shape) * ulp).astype(
        np.float32)
    rows[:, :, 9:15] = rng.uniform(-0.5, 2.0, (n, 16, 6))
    rows[rng.random((n, 16)) < 0.03, 5] = np.nan
    rows[rng.random((n, 16)) < 0.05, :9] = [0, 0, -1] * 3
    return rows


def _random_tiles(rng, n: int) -> np.ndarray:
    """Tiles of a 1920×1080 frame, a third of them on its right or bottom
    edge."""
    tx = rng.integers(0, NTX, n)
    ty = rng.integers(0, NTY, n)
    edge = rng.random(n) < 0.33
    tx = np.where(edge & (rng.random(n) < 0.5), NTX - 1, tx)
    ty = np.where(edge & (tx != NTX - 1), NTY - 1, ty)
    return ty * NTX + tx


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_region_test_is_exact(seed):
    """Per (row, edge, region): the corner value equals the maximum of the
    edge over the region's 128 pixel centres (bit for bit, where no value
    is NaN), and a rejected (row, region) has no pixel passing the cover
    test."""
    rng = np.random.default_rng(seed)
    n = 96
    tiles_np = _random_tiles(rng, n)
    rows = torch.from_numpy(_random_rows(rng, tiles_np))
    tiles = torch.from_numpy(tiles_np)
    px, py = (c[:, None, :] for c in raster.tile_centres(tiles, NTX))
    region = _pixel_region()
    emax = raster.region_edge_max(rows, tiles, NTX)            # (n,16,3,8)
    for e in range(3):
        a, b, c = (rows[:, :, 3 * e + i, None] for i in range(3))
        ev = a * px + b * py + c                               # (n,16,1024)
        per_region = ev.view(n, 16, 1, raster.TILE_PX).expand(
            -1, -1, raster.N_REGIONS, -1)
        in_region = (region[None, :] == torch.arange(
            raster.N_REGIONS)[:, None])                        # (8,1024)
        vals = torch.where(in_region, per_region, -torch.inf)
        finite = ~torch.where(in_region, per_region.isnan(), False).any(-1)
        want = vals.amax(-1)
        got = emax[:, :, e]
        assert (got[finite] == want[finite]).all()
        assert got[~finite].isnan().all()
    keep = raster.region_keep(rows, tiles, NTX)                # (n,16,8)
    cover, _d = raster._tile_cover(rows, tiles, NTX)           # (n,16,1024)
    assert not (cover & ~keep[:, :, region]).any()
    # the property is not vacuous: both outcomes occur, near-degenerate
    # edges included; NaN edges are kept, invalid rows always rejected
    assert 0.05 < float(keep.float().mean()) < 0.95
    assert int(cover.sum()) > 1000
    invalid = (rows[:, :, :9] == torch.tensor([0.0, 0.0, -1.0] * 3)).all(-1)
    assert invalid.any() and not keep[invalid].any()
    nan_rows = rows[:, :, 5].isnan()
    others = ~((emax[:, :, 0] < 0) | (emax[:, :, 2] < 0))
    assert nan_rows.any() and emax[:, :, 1][nan_rows].isnan().all()
    assert (keep[nan_rows] == others[nan_rows]).all()


def test_region_test_on_pixel_edges():
    """Edges through pixel centres exactly (e = 0 there): the region holding
    that centre keeps the row, whatever the slope's magnitude or sign."""
    rng = np.random.default_rng(5)
    n = 64
    tiles = torch.from_numpy(_random_tiles(rng, n))
    px, py = raster.tile_centres(tiles, NTX)
    r = torch.from_numpy(rng.integers(0, raster.TILE_PX, n))
    x = px[torch.arange(n), r].double()
    y = py[torch.arange(n), r].double()
    rows = torch.zeros((n, 16, 16))
    for e in range(3):
        a = torch.from_numpy(rng.choice([0.0, 1.0, -1.0, 2.0, -0.5], (n, 16)))
        b = torch.from_numpy(rng.choice([0.0, -1.0, 1.0, 4.0], (n, 16)))
        rows[:, :, 3 * e] = a.float()
        rows[:, :, 3 * e + 1] = b.float()
        rows[:, :, 3 * e + 2] = (-(a * x[:, None] + b * y[:, None])).float()
    keep = raster.region_keep(rows, tiles, NTX)
    assert keep[torch.arange(n), :, _pixel_region()[r]].all()


def _region_merge(bins, ntx, n_tiles, depth_only, rows=None):
    """The plain merge of visibility_tiles_plain with each (row, pixel)
    candidate dropped unless region_keep keeps the row for the pixel's
    region: what the kernel evaluates. `rows` = (record rows (E, 16, 16),
    triangle ids (E, 16), tiles (E,)) replaces the bins' hit sub-blocks as
    the staged rows. Returns (frame, kept pairs, tested pairs)."""
    if rows is None:
        e_tile, e_base = raster.hit_sub_blocks(bins)
        tid = e_base[:, None] + torch.arange(raster.SUB)
        rc = bins.records[tid]
    else:
        rc, tid, e_tile = rows
    cover, d = raster._tile_cover(rc, e_tile, ntx)
    keep = raster.region_keep(rc, e_tile, ntx)
    key = raster._cover_keys(cover & keep[:, :, _pixel_region()], d, tid,
                             depth_only).amin(dim=1)
    keys = raster._background_keys(n_tiles, depth_only, "cpu")
    keys.scatter_reduce_(0, e_tile[:, None].expand_as(key), key, "amin")
    return (raster._keys_to_frame(keys, depth_only), int(keep.sum()),
            keep.numel())


@pytest.mark.parametrize("depth_only", [False, True],
                         ids=["colour", "depth_only"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_region_merge_equals_full_sweep(scene, depth_only):
    (_js, ps), w = SCENES[scene](np.random.default_rng(1234))
    bins = raster.build_bins(ps, w, H)
    ntx = -(-w // raster.TILE)
    n_tiles = ntx * -(-H // raster.TILE)
    got, kept, tested = _region_merge(bins, ntx, n_tiles, depth_only)
    want = raster.visibility_tiles_plain(bins, ntx, n_tiles,
                                         depth_only=depth_only)
    if depth_only:
        got, want = (got,), (want,)
    else:
        assert int((got[1] >= 0).sum()) > 500
    for g, wnt in zip(got, want):
        assert (g.view(torch.int32) == wnt.view(torch.int32)).all()
    assert 0 < kept < tested
    assert int(raster.region_kept(bins, ntx, n_tiles).sum()) == kept


def test_region_thread_map():
    """A permutation of the tile's 1024 pixels; warp w's 128 pixels fill
    its 16×8 region (columns 16·(w % 2) …, rows 8·(w // 2) …); each store
    of a warp (fixed k) is two 16-pixel row runs."""
    tmap = _thread_map()
    assert tmap.shape == (VIS_THREADS, 4)
    assert torch.equal(tmap.reshape(-1).sort().values,
                       torch.arange(raster.TILE_PX))
    row, col = tmap // raster.TILE, tmap % raster.TILE
    for w in range(raster.N_REGIONS):
        r, c = row[32 * w:32 * w + 32], col[32 * w:32 * w + 32]
        assert set(c.reshape(-1).tolist()) == set(
            range(raster.REGION_W * (w % 2), raster.REGION_W * (w % 2 + 1)))
        assert set(r.reshape(-1).tolist()) == set(
            range(raster.REGION_H * (w // 2),
                  raster.REGION_H * (w // 2 + 1)))
        for k in range(4):
            runs = tmap[32 * w:32 * w + 32, k].view(2, 16)
            assert (runs.diff(dim=1) == 1).all()


def test_region_kept_share_on_bench_scene():
    """bench.py's sphere grid at 4×4 and 1920×1080: the kernel evaluates a
    small share of the (triangle, region) pairs of the hit sub-blocks; the
    bound's (triangle, pixel) count lies between the covered pixels and the
    region design's count."""
    from trident_tpu_torch.tools_dev.scenes import build_bench_scene, rotate

    r, reg = build_bench_scene(4, "cpu")
    rotate(reg, 0)
    cs, _rec, bins, w, h = kbench.frame_bins(r)
    ntx = -(-w // raster.TILE)
    n_tiles = ntx * -(-h // raster.TILE)
    kept = raster.region_kept(bins, ntx, n_tiles)
    tested = kbench.hit_total(bins) * raster.SUB * raster.N_REGIONS
    assert bins.aux.tolist() == [0, 0] and tested > 100_000
    assert 0 < int(kept.sum()) < 0.25 * tested
    n_bbox = kbench.bbox_pixel_pairs(bins, cs.setup, ntx)
    _d, tri = raster.visibility_tiles_plain(bins, ntx, n_tiles)
    covered = int((raster.untile_frame(tri, ntx, -(-h // raster.TILE))
                   [:h, :w] >= 0).sum())
    region_px = raster.REGION_W * raster.REGION_H
    assert covered < n_bbox < int(kept.sum()) * region_px


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_bbox_pixel_pairs(scene):
    """bbox_pixel_pairs counts, per hit sub-block, each valid triangle's
    tile pixels whose centre lies in the bbox of its vertices (each the
    cross product of two edge rows) and in the binner's bbox; every pixel
    of the frame that a triangle of the sub-block covers is among them."""
    (_js, ps), w = SCENES[scene](np.random.default_rng(1234))
    bins = raster.build_bins(ps, w, H)
    ntx = -(-w // raster.TILE)
    e = ps.edge.double()
    v = torch.stack([torch.linalg.cross(e[:, j], e[:, k])
                     for j, k in ((1, 2), (2, 0), (0, 1))], dim=1)
    x, y = v[..., 0] / v[..., 2], v[..., 1] / v[..., 2]
    e_tile, e_base = raster.hit_sub_blocks(bins)
    tid = e_base[:, None] + torch.arange(raster.SUB)
    t = tid.clamp(max=ps.valid.shape[0] - 1)
    px, py = (c[:, None, :].double() for c in raster.tile_centres(e_tile, ntx))
    bb = ps.bbox.long()[t]
    exact = ~(ps.w <= 1e-6).any(1)[t, None]
    inside = (torch.where(exact, (px >= x.amin(1)[t, None])
                          & (px <= x.amax(1)[t, None])
                          & (py >= y.amin(1)[t, None])
                          & (py <= y.amax(1)[t, None]), True)
              & (px - 0.5 >= bb[..., 0:1]) & (px - 0.5 < bb[..., 2:3])
              & (py - 0.5 >= bb[..., 1:2]) & (py - 0.5 < bb[..., 3:4])
              & ((tid < ps.valid.shape[0]) & ps.valid[t])[..., None])
    n = kbench.bbox_pixel_pairs(bins, ps, ntx)
    assert n == int(inside.sum()) > 1000
    cover, _d = raster._tile_cover(bins.records[tid], e_tile, ntx)
    in_frame = (px < w) & (py < H)
    assert int((cover & in_frame).sum()) > 1000
    assert not (cover & in_frame & ~inside).any()
