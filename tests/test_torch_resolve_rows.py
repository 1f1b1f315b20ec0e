"""The port's row-major resolve record table (T, RR_WIDTH) and the resolve
kernel's 32×8 CTA map, on the CPU.

  * the producer (ops/planes.py build_resolve_cols_planar) equals the
    record columns stacked and transposed, bit for bit, pad columns zero;
  * the plain versions on the row table equal the column-table plain
    versions kept below (the port's layout before the row table), bit for
    bit, on test_torch_raster.py's scenes: (H, W), tiled and fused;
  * a model of csrc/resolve.cu's (H, W) instance — 32×8-pixel CTAs, one
    warp per 32-pixel row segment, each warp's 2 KB of output staged in
    XOR-swizzled shared memory and stored as consecutive float4s — writes
    every output float4 exactly once with its own pixel's channels, and
    neither its staging writes nor its reads conflict on a bank;
  * every wrapper raises on a table the kernels cannot read: the (RW, T)
    column layout, a non-contiguous view, a base that is not 16-byte
    aligned, another dtype;
  * records_from_reference carries the JAX package's (RW, T) table across
    and back unchanged.
"""

import numpy as np
import pytest
import torch

from test_torch_raster import H, SCENES

from trident_tpu_torch import _build
from trident_tpu_torch.ops import planes as P
from trident_tpu_torch.ops import raster, resolve
from trident_tpu_torch.ops.corner import CornerCols
from trident_tpu_torch.ops.vertex import SetupCols

torch.set_num_threads(1)

# csrc/resolve.cu's (H, W) instance
BLOCK_W, BLOCK_H = 32, 8
QUADS = resolve.CHANNELS // 4        # float4s per pixel
BANKS = 32                           # 4-byte shared-memory banks


def _random_corner_cols(rng, t: int) -> CornerCols:
    def cols(n):
        return tuple(torch.from_numpy(rng.standard_normal(t).astype(
            np.float32)) for _ in range(n))

    return CornerCols(setup=SetupCols(e=cols(9), z=cols(3), w=cols(3)),
                      nrm=cols(9), uv=cols(6), consts=cols(12))


def _random_records(rng, t: int) -> torch.Tensor:
    """(T, RR_WIDTH) records with g1·p well away from 0 and the pad columns
    zero, as the producer leaves them."""
    rec = rng.standard_normal((t, P.RR_WIDTH)).astype(np.float32)
    rec[:, P.RR_G1 + 2] = rng.uniform(20.0, 60.0, t)
    rec[:, [P.RR_TSX, P.RR_TSY]] = rng.choice([64.0, 128.0], (t, 2))
    rec[:, P.RR_EDGE + 1:] = 0.0
    return torch.from_numpy(rec)


# -- the column-table plain versions (the (RW, T) layout), kept as the
#    reference the row-table plain versions must equal bit for bit ---------

def _resolve_cols_plain(tri_id, cols):
    h, w = tri_id.shape
    flat = tri_id.reshape(-1)
    sel = cols[:, flat.clamp_min(0).long()]                  # (RW, H·W)
    ys = torch.arange(h, dtype=torch.float32) + 0.5
    xs = torch.arange(w, dtype=torch.float32) + 0.5
    pyf = ys[:, None].expand(h, w).reshape(-1)
    pxf = xs[None, :].expand(h, w).reshape(-1)
    attrs = resolve.eval_interpolants(sel, pxf, pyf).T        # (H·W, CH)
    attrs = torch.where((flat >= 0)[:, None], attrs, 0.0)
    return attrs.reshape(h, w, resolve.CHANNELS)


def _resolve_tiled_cols_plain(tri_tiles, cols, ntx):
    n_tiles = tri_tiles.shape[0]
    flat = tri_tiles.reshape(-1)
    pxf, pyf = raster.tile_centres(torch.arange(n_tiles), ntx)
    attrs = resolve.eval_interpolants(cols[:, flat.clamp_min(0).long()],
                                      pxf.reshape(-1), pyf.reshape(-1))
    attrs = torch.where(flat >= 0, attrs, 0.0)               # (CH, N)
    return attrs.view(resolve.CHANNELS, n_tiles, raster.TILE_PX) \
        .permute(1, 0, 2).contiguous()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def test_producer_is_the_stacked_columns_transposed():
    cc = _random_corner_cols(np.random.default_rng(5), 1000)
    rows = P.build_resolve_cols_planar(cc)
    cols = torch.stack(P.resolve_parts(cc), dim=0)
    n = cols.shape[0]
    assert n == P.RR_EDGE + 1
    assert rows.shape == (1000, P.RR_WIDTH) and rows.is_contiguous()
    assert rows.dtype == torch.float32 and rows.data_ptr() % 16 == 0
    assert torch.equal(_bits(rows[:, :n]), _bits(cols.T))
    assert (_bits(rows[:, n:]) == 0).all()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_row_plain_versions_equal_column_plain_versions(scene):
    (_js, ps), w = SCENES[scene](np.random.default_rng(1234))
    before = dict(_build.LAUNCHES)
    t = ps.edge.shape[0]
    records = _random_records(np.random.default_rng(7), t)
    cols = records.T.contiguous()
    bins = raster.build_bins(ps, w, H)
    ntx, nty = -(-w // raster.TILE), -(-H // raster.TILE)
    n_tiles = ntx * nty
    _d, tri_t = raster.visibility_tiles_plain(bins, ntx, n_tiles)
    tri = raster.untile_frame(tri_t, ntx, nty)[:H, :w].contiguous()
    assert int((tri >= 0).sum()) > 500 and int((tri < 0).sum()) > 0

    hw = resolve.resolve_attrs(tri, records)                 # CPU: plain
    assert torch.equal(_bits(hw), _bits(_resolve_cols_plain(tri, cols)))
    tiled = resolve.resolve_attrs_tiled(tri_t, records, ntx)
    want_t = _resolve_tiled_cols_plain(tri_t, cols, ntx)
    assert torch.equal(_bits(tiled), _bits(want_t))
    fd, ft, fa = resolve.fused_visibility_resolve(bins, records, ntx,
                                                  n_tiles)
    assert torch.equal(ft, tri_t)
    assert torch.equal(_bits(fa), _bits(want_t))
    assert dict(_build.LAUNCHES) == before        # CPU: no launch


def _stage_slot(p, q):
    """csrc/resolve.cu stage_slot: pixel p's float4 q in the warp's
    staging buffer."""
    return p * QUADS + (q ^ ((p >> 1) & (QUADS - 1)))


def _quarter_warp_groups(slots):
    """(..., 32) float4 slots accessed by one warp instruction → (..., 4, 8)
    4-bank groups, one row per quarter warp (a 16-byte access by 32 lanes
    goes to shared memory as four 8-lane phases)."""
    return ((slots * 4) % BANKS // 4).reshape(*slots.shape[:-1], 4, 8)


@pytest.mark.parametrize("h, w", [(1080, 1920), (540, 960), (256, 256),
                                  (127, 129)])
def test_cta_map_writes_every_float4_once(h, w):
    gx, gy = -(-w // BLOCK_W), -(-h // BLOCK_H)
    bx, by, warp, lane = np.meshgrid(np.arange(gx), np.arange(gy),
                                     np.arange(BLOCK_H), np.arange(BLOCK_W),
                                     indexing="ij")
    y = by * BLOCK_H + warp
    x0 = bx * BLOCK_W
    n = np.minimum(BLOCK_W, w - x0)
    live = y < h                              # warps past the frame return
    p0 = y.astype(np.int64) * w + x0
    # phase 1: lane l resolves pixel (y, x0 + l), writes its QUADS float4s
    resolves = live & (lane < n)
    pix = (p0 + lane)[resolves]
    assert np.array_equal(np.sort(pix), np.arange(h * w))
    # phase 2: float4 f = k·32 + lane of the segment is read from the slot
    # pixel f // 4 wrote for its quad f % 4 and stored at p0·4 + f
    written = np.zeros(h * w * QUADS, np.int64)
    for k in range(QUADS):
        f = k * BLOCK_W + lane
        p, q = f // QUADS, f % QUADS
        ok = live & (p < n)
        slot = _stage_slot(p, q)
        # the slot holds that pixel's quad q: the swizzle is a bijection
        # within the warp's 128 slots
        assert (slot[ok] // QUADS == p[ok]).all()
        dst = (p0 * QUADS + f)[ok]
        assert ((dst // QUADS) == (p0 + p)[ok]).all()
        written += np.bincount(dst, minlength=written.size)
        # each full instruction stores one contiguous 512-byte run: four
        # whole 128-byte lines where the row starts on a line (W even)
        full = live[..., 0] & (n[..., 0] == BLOCK_W)
        addr = (p0 * QUADS + f)[full] * 16
        assert (np.diff(addr, axis=-1) == 16).all()
        assert ((addr[:, 0] % 128 == 0) | (w % 2 == 1)).all()
    assert (written == 1).all()


def test_staging_is_free_of_bank_conflicts():
    lane = np.arange(BLOCK_W)
    slots = np.stack([_stage_slot(lane, q) for q in range(QUADS)])
    assert np.array_equal(np.sort(slots.reshape(-1)),
                          np.arange(BLOCK_W * QUADS))
    # writes: every lane its own pixel, one quad per instruction
    for g in _quarter_warp_groups(slots):
        assert all(len(set(row)) == 8 for row in g.tolist())
    # reads: instruction k, lane l reads the segment's float4 32k + l
    for k in range(QUADS):
        f = k * BLOCK_W + lane
        for row in _quarter_warp_groups(_stage_slot(f // QUADS, f % QUADS)):
            assert len(set(row.tolist())) == 8


def _bad_tables():
    t = 300
    good = _random_records(np.random.default_rng(3), t)
    flat = torch.zeros(t * P.RR_WIDTH + 1)
    return {
        "columns": good.T.contiguous(),                       # (RW, T)
        "non_contiguous": torch.zeros(t, 2 * P.RR_WIDTH)[:, ::2],
        "misaligned": flat[1:].view(t, P.RR_WIDTH),
        "float64": good.double(),
    }


@pytest.mark.parametrize("table", ["columns", "non_contiguous", "misaligned",
                                   "float64"])
@pytest.mark.parametrize("wrapper", ["resolve", "tiled", "fused"])
def test_wrappers_raise_on_unreadable_tables(wrapper, table):
    (_js, ps), w = SCENES["random"](np.random.default_rng(1234))
    bins = raster.build_bins(ps, w, H)
    ntx, nty = -(-w // raster.TILE), -(-H // raster.TILE)
    records = _bad_tables()[table]
    if table == "misaligned":
        assert records.is_contiguous() and records.data_ptr() % 16 != 0
    ids_t = torch.zeros((ntx * nty, raster.TILE_PX), dtype=torch.int32)
    call = {
        "resolve": lambda: resolve.resolve_attrs(
            torch.zeros((H, w), dtype=torch.int32), records),
        "tiled": lambda: resolve.resolve_attrs_tiled(ids_t, records, ntx),
        "fused": lambda: resolve.fused_visibility_resolve(
            bins, records, ntx, ntx * nty),
    }[wrapper]
    with pytest.raises(ValueError, match="records must be"):
        call()


def test_records_from_reference_round_trips():
    rng = np.random.default_rng(11)
    cols = rng.standard_normal((P.RR_WIDTH, 777)).astype(np.float32)
    rows = P.records_from_reference(cols)
    assert rows.shape == (777, P.RR_WIDTH) and rows.is_contiguous()
    assert rows.dtype == torch.float32 and rows.data_ptr() % 16 == 0
    back = rows.T.numpy()
    assert (back.view(np.int32) == cols.view(np.int32)).all()
    # the JAX package's vertex-colour width (40) carries across as well
    cols_vc = rng.standard_normal((P.RR_WIDTH_VCOLOR, 77)).astype(np.float32)
    rows_vc = P.records_from_reference(cols_vc)
    assert rows_vc.shape == (77, P.RR_WIDTH_VCOLOR)
    assert (rows_vc.T.numpy().view(np.int32) == cols_vc.view(np.int32)).all()
    # no other width has a port layout
    with pytest.raises(ValueError):
        P.records_from_reference(np.zeros((36, 5), np.float32))
