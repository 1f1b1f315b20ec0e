"""The compact-bank visibility kernel's schedule (csrc/visibility_ck.cu):
per tile, each pair of its range stages the first 16·min(nhit, 16) rows of
its bank table row (one bulk copy), ids from column 15, and each warp
merges only the rows that the region test (raster.region_keep) keeps for
its 16×8 region; a pad pair (nhit 0) stages nothing. The TPU's bank
schedule, which the plain twin visibility_ck_tiles_plain keeps, also runs
a bank's padding copies; those are copies of an already merged triangle.

On test_torch_raster.py's scenes at every ck_bank the tests hold that this
plain model of the kernel is bit-equal to visibility_ck_tiles_plain and
to visibility_tiles_plain, that it keeps exactly the (triangle, region)
pairs K1 keeps on the same bins (raster.region_kept), and that a pad pair
inside a tile's range contributes nothing.
"""

import numpy as np
import pytest
import torch

from trident_tpu_torch.ops import raster

from test_torch_raster import H, SCENES
from test_torch_vis_region import _region_merge

torch.set_num_threads(1)

BANKS = [2, 3, 8, 16]


def _live_rows(bins, n_tiles):
    """(record rows (E, 16, 16), ids (E, 16), tiles (E,)) of the sub-block
    slots the kernel stages: for each tile t and pair p in [tile_start[t],
    tile_start[t + 1]), slots 0 … min(nhit[p], 16) − 1 of p's bank row,
    with the triangle ids of column 15."""
    n_pairs, rows, _ = bins.banks.shape
    slots = bins.banks.view(n_pairs, rows // raster.SUB, raster.SUB,
                            raster.REC)
    p = torch.arange(n_pairs)
    tile = torch.searchsorted(bins.tile_start.long(), p, right=True) - 1
    walked = tile < n_tiles
    live = ((torch.arange(raster.NSUB) < bins.nhit.clamp(max=raster.NSUB)
             .long()[:, None]) & walked[:, None])
    p_idx, s_idx = torch.nonzero(live, as_tuple=True)
    rc = slots[p_idx, s_idx]
    return rc, rc[:, :, raster.REC - 1].to(torch.int32), tile[p_idx]


def _bins(scene, ck_bank):
    (_js, ps), w = SCENES[scene](np.random.default_rng(1234))
    bins = raster.build_bins(ps, w, H, ck_bank=ck_bank)
    ntx = -(-w // raster.TILE)
    return bins, ntx, ntx * -(-H // raster.TILE)


def _same(a, b) -> bool:
    return bool((a.view(torch.int32) == b.view(torch.int32)).all())


@pytest.mark.parametrize("ck_bank", BANKS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_ck_region_merge_equals_plain(scene, ck_bank):
    """The kernel's schedule on the bank table equals the TPU's bank
    schedule and K1's plain version bit for bit, and keeps K1's (triangle,
    region) pairs."""
    bins, ntx, n_tiles = _bins(scene, ck_bank)
    assert bins.aux.tolist() == [0, 0]
    rows = _live_rows(bins, n_tiles)
    # every walked pair's tile is its pair_tile; the pads lie past them
    assert torch.equal(rows[2], bins.pair_tile[
        torch.repeat_interleave(bins.nhit.long())].long())
    (depth, tri), kept, _tested = _region_merge(bins, ntx, n_tiles, False,
                                                rows=rows)
    ck_d, ck_t = raster.visibility_ck_tiles_plain(bins, ntx, n_tiles,
                                                  ck_bank)
    k1_d, k1_t = raster.visibility_tiles_plain(bins, ntx, n_tiles)
    assert int((tri >= 0).sum()) > 500
    assert torch.equal(tri, ck_t) and _same(depth, ck_d)
    assert torch.equal(tri, k1_t) and _same(depth, k1_d)
    assert kept == int(raster.region_kept(bins, ntx, n_tiles).sum()) > 0


@pytest.mark.parametrize("ck_bank", BANKS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_ck_pad_pair_contributes_nothing(scene, ck_bank):
    """A pair of a tile's range whose nhit is 0 stages no slot: the frame
    is that of the bins with the pair's mask cleared, under the kernel's
    schedule and the TPU's. The table's own pads (past n_real, nhit 0)
    lie past every tile's range."""
    bins, ntx, n_tiles = _bins(scene, ck_bank)
    n_real = int(bins.n_real)
    assert int(bins.tile_start[-1]) == n_real
    assert (bins.nhit[n_real:] == 0).all() and (bins.nhit[:n_real] > 0).all()
    pads = torch.arange(bins.nhit.shape[0]) % 5 == 2
    pads &= torch.arange(bins.nhit.shape[0]) < n_real
    padded = bins._replace(nhit=torch.where(pads, 0, bins.nhit),
                           pair_mask=torch.where(pads, 0, bins.pair_mask))
    (depth, tri), _kept, _t = _region_merge(
        padded, ntx, n_tiles, False, rows=_live_rows(padded, n_tiles))
    want_d, want_t = raster.visibility_tiles_plain(padded, ntx, n_tiles)
    ck_d, ck_t = raster.visibility_ck_tiles_plain(
        bins._replace(nhit=padded.nhit), ntx, n_tiles, ck_bank)
    assert torch.equal(tri, want_t) and _same(depth, want_d)
    assert torch.equal(tri, ck_t) and _same(depth, ck_d)
    # not vacuous: the cleared pairs held winners
    _d, full_t = raster.visibility_tiles_plain(bins, ntx, n_tiles)
    assert int((full_t != tri).sum()) > 0
