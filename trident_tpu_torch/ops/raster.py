"""Production visibility pass: tile binning + the visibility kernel.

Port of trident_tpu/ops/raster_pallas.py (build_bins, the visibility
kernel and the untile). The result is defined per pixel and independent of
how the binner groups work: every valid triangle covering a pixel centre
competes, and the pixel keeps the lexicographic (min depth, max triangle
id) — the reference's LESS_OR_EQUAL, later-draw-wins depth state. Any
conservative binning gives the same image; this one is chosen for the card:

  1. Triangles form CHUNK = 256 records of 16 SUB-triangle sub-blocks
     (meshes are Morton-ordered at build time, so sub-blocks are compact).
  2. Each non-empty sub-block claims exactly the 32×32 tiles of its bbox in
     ONE flat pool of `pool` slots (a cumsum over sub-block tile areas; a
     searchsorted maps slots back). Keys (tile, chunk) sort once; equal
     keys merge into one pair whose 16-bit mask has a bit per hit
     sub-block. Shapes are static: no host sync on the frame path.
  3. The kernel (csrc/visibility.cu) runs one CTA per tile over that
     tile's contiguous pair range (tile_start, from a searchsorted). Its
     depth-only instance renders the shadow map's light pass. Each of its
     8 warps owns one 16×8 region of the tile and merges only the staged
     triangles that region_keep (the kernel's exact corner test, in plain
     PyTorch here) keeps for that region; the result is the same.

Capacity: sub-blocks whose claim runs past the pool end lose those tiles
and their chunks are counted in aux[1]; pairs past `pair_budget` are
dropped and counted in aux[0]. Overflow drops geometry, never writes
garbage. Tiles no pair touches come out as background (depth 1, id −1)
straight from the kernel, which writes every tile.

The `ckern` knob (build_bins(ck_bank=...)) adds the compact-bank table of
raster_pallas.py:835-857: per kept pair, its hit sub-blocks' record rows
gathered contiguous (ascending q, padded with copies of the first hit to
ceil(16/ck_bank)·ck_bank slots), triangle ids in column 15, and the hit
count nhit; csrc/visibility_ck.cu reads it. At 16 KB a pair (ck_bank 8)
the table is capped at CK_PAIR_BUDGET pairs, the JAX package's CKERN
budget (raster_pallas.py:425-426); pairs past it are counted in aux[0].
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from trident_tpu_torch import _build
from trident_tpu_torch.ops.vertex import SetupCols, TriangleSetup
from trident_tpu_torch.render.types import GBuffer

Tensor = torch.Tensor

TILE = 32                  # raster tiles are TILE × TILE pixels
TILE_PX = TILE * TILE
CHUNK = 256                # triangles per pair record block
SUB = 16                   # triangles per hit-maskable sub-block
NSUB = CHUNK // SUB        # 16 → one 16-bit hit mask per pair
REC = 16                   # floats per visibility record row
_BG_KEY = (0x3F800000 << 32) | 0x80000000   # (depth 1.0, id −1)
_NO_KEY = (1 << 63) - 1
CK_PAIR_BUDGET = 20480     # compact-bank pairs (ckern): 335 MB at ck_bank 8
CK_MAX_TRIANGLES = 1 << 24  # bank ids ride an f32 column, exact below 2^24
REGION_W, REGION_H = 16, 8  # one warp's pixel region of a tile
N_REGIONS = TILE_PX // (REGION_W * REGION_H)   # 8 warps per tile


class Bins(NamedTuple):
    records: Tensor      # (Tpad, 16) f32: e0 e1 e2 as (a,b,c), z(3), w(3), pad
    pair_tile: Tensor    # (NP,) i32 tile per pair, sorted; padding = n_tiles
    pair_chunk: Tensor   # (NP,) i32 chunk per pair (0 on padding)
    pair_mask: Tensor    # (NP,) i32 hit sub-blocks, bit q (0 on padding)
    tile_start: Tensor   # (n_tiles+1,) i32: tile t owns pairs [s[t], s[t+1])
    n_real: Tensor       # () i64 pairs kept (a sorted prefix)
    aux: Tensor          # (2,) i32 [truncated pairs, dropped chunks]
    banks: Optional[Tensor] = None  # ckern: (NP, nbank·SUB, 16) f32 hit
                                    # sub-block rows, id in column 15
    nhit: Optional[Tensor] = None   # ckern: (NP,) i32 hit sub-blocks


def default_pool(n_sub: int, n_tiles: int) -> int:
    """Static pool size: the worst case (every sub-block spans the frame)
    when that is small, else ~4 tiles per sub-block plus 16 full-frame
    sub-blocks' worth of headroom for near-plane / huge triangles."""
    return min(n_sub * n_tiles, 4 * n_sub + 16 * n_tiles + 65536)


def _build_records(setup: TriangleSetup, tpad: int,
                   setup_cols: Optional[SetupCols]) -> Tensor:
    """(tpad, 16) rows; invalid and padding triangles get e ≡ −1 (never
    cover). Triangle ids are the row index, so they stay exact at any T."""
    valid = setup.valid
    t = valid.shape[0]
    if setup_cols is not None:
        ecol = lambda k, c: setup_cols.e[3 * k + c]          # noqa: E731
        zcol = lambda k: setup_cols.z[k]                     # noqa: E731
        wcol = lambda k: setup_cols.w[k]                     # noqa: E731
    else:
        ecol = lambda k, c: setup.edge[:, k, c]              # noqa: E731
        zcol = lambda k: setup.z[:, k]                       # noqa: E731
        wcol = lambda k: setup.w[:, k]                       # noqa: E731
    cols = []
    for k in range(3):
        cols += [torch.where(valid, ecol(k, 0), 0.0),
                 torch.where(valid, ecol(k, 1), 0.0),
                 torch.where(valid, ecol(k, 2), -1.0)]
    cols += [torch.where(valid, zcol(k), 0.0) for k in range(3)]
    cols += [torch.where(valid, wcol(k), 1.0) for k in range(3)]
    cols.append(torch.zeros_like(cols[0]))
    rec = torch.stack(cols, dim=1)
    if tpad != t:
        # e ≡ (0, 0, −1), z 0, w 1: filled on the device (a host-to-device
        # copy could not be captured in a CUDA graph)
        empty = rec.new_zeros((tpad - t, REC))
        empty[:, 2:9:3] = -1.0
        empty[:, 12:15] = 1.0
        rec = torch.cat([rec, empty], dim=0)
    return rec.contiguous()


def build_bins(setup: TriangleSetup, width: int, height: int,
               setup_cols: Optional[SetupCols] = None,
               pool: Optional[int] = None,
               pair_budget: Optional[int] = None, ck_bank: int = 0) -> Bins:
    """Bin triangles to 32×32 tiles for a width × height target. `pool`
    (emission slots) and `pair_budget` (kept pairs) are capacities;
    overflow is counted in aux, see the module note. ck_bank > 0 (the
    ckern knob) also builds the compact-bank table, with pair_budget
    defaulting to CK_PAIR_BUDGET."""
    dev = setup.valid.device
    t = setup.valid.shape[0]
    n_chunks = max(1, -(-t // CHUNK))
    tpad = n_chunks * CHUNK
    if ck_bank and tpad >= CK_MAX_TRIANGLES:
        raise ValueError(
            f"{t} triangles: compact-bank ids ride an f32 record column, "
            "exact only below 2^24 — split the scene across draws")
    n_sub = n_chunks * NSUB
    ntx, nty = -(-width // TILE), -(-height // TILE)
    n_tiles = ntx * nty
    if pool is None:
        pool = default_pool(n_sub, n_tiles)
    if ck_bank and pair_budget is None:
        pair_budget = CK_PAIR_BUDGET
    budget = pool if pair_budget is None else min(pair_budget, pool)

    records = _build_records(setup, tpad, setup_cols)

    valid = setup.valid
    bbox = setup.bbox.long()
    if tpad != t:
        valid = torch.cat([valid, valid.new_zeros(tpad - t)])
        bbox = torch.cat([bbox, bbox.new_zeros(tpad - t, 4)])
    big = 1 << 20

    def sub_min(col):
        return torch.where(valid, bbox[:, col], big).view(n_sub, SUB).amin(1)

    def sub_max(col):
        return torch.where(valid, bbox[:, col], 0).view(n_sub, SUB).amax(1)

    qx0, qy0, qx1, qy1 = sub_min(0), sub_min(1), sub_max(2), sub_max(3)
    q_nonempty = (qx1 > qx0) & (qy1 > qy0)
    qtx0 = torch.clamp(qx0 // TILE, 0, ntx - 1)
    qty0 = torch.clamp(qy0 // TILE, 0, nty - 1)
    span_x = torch.where(q_nonempty,
                         torch.clamp((qx1 - 1) // TILE, 0, ntx - 1) - qtx0 + 1, 0)
    span_y = torch.where(q_nonempty,
                         torch.clamp((qy1 - 1) // TILE, 0, nty - 1) - qty0 + 1, 0)
    area = span_x * span_y
    ends = torch.cumsum(area, 0)
    starts = ends - area

    # pool slot j → (sub-block s, tile of its bbox), row-major in the bbox
    j = torch.arange(pool, device=dev)
    s = torch.searchsorted(ends, j, right=True)
    in_pool = s < n_sub
    s = torch.clamp(s, max=n_sub - 1)
    i = j - starts[s]
    sx = torch.clamp(span_x[s], min=1)
    tile = (qty0[s] + i // sx) * ntx + qtx0[s] + i % sx
    sentinel = n_tiles * n_chunks
    key = torch.where(in_pool, tile * n_chunks + s // NSUB, sentinel)
    bit = torch.where(in_pool, torch.bitwise_left_shift(1, s % NSUB), 0)

    key, perm = torch.sort(key)
    bit = bit[perm]
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    pair_id = torch.cumsum(new, 0) - 1
    n_real_total = (new & (key != sentinel)).sum()
    pair_key = torch.full_like(key, sentinel).scatter_(0, pair_id, key)
    pair_mask = torch.zeros_like(key).index_add_(0, pair_id, bit)

    n_real = torch.clamp(n_real_total, max=budget)
    keep = torch.arange(budget, device=dev) < n_real
    pair_key = torch.where(keep, pair_key[:budget], sentinel)
    pair_mask = torch.where(keep, pair_mask[:budget], 0)
    pair_tile = pair_key // n_chunks
    tile_start = torch.searchsorted(
        pair_tile, torch.arange(n_tiles + 1, device=dev))

    n_dropped = (q_nonempty & (ends > pool)).view(n_chunks, NSUB).any(1).sum()
    pair_chunk = (pair_key % n_chunks).to(torch.int32)
    pair_mask = pair_mask.to(torch.int32)
    banks = nhit = None
    if ck_bank:
        banks, nhit = _ck_banks(records, pair_chunk, pair_mask, ck_bank)
    return Bins(records=records,
                pair_tile=pair_tile.to(torch.int32),
                pair_chunk=pair_chunk, pair_mask=pair_mask,
                tile_start=tile_start.to(torch.int32),
                n_real=n_real,
                aux=torch.stack([n_real_total - n_real,
                                 n_dropped]).to(torch.int32),
                banks=banks, nhit=nhit)


def _ck_banks(records: Tensor, pair_chunk: Tensor, pair_mask: Tensor,
              ck_bank: int):
    """The compact-bank table (raster_pallas.py:835-857): each pair's hit
    sub-blocks in ascending q, then copies of its first hit up to
    nbank = ceil(NSUB/ck_bank)·ck_bank slots (the lexicographic merge is
    idempotent, so copies are bit-exactly free), gathered as (NP,
    nbank·SUB, 16) record rows with each triangle's global id in column
    15; and nhit (NP,) i32. Padding pairs (mask 0) have nhit 0."""
    dev = records.device
    nbank = -(-NSUB // ck_bank) * ck_bank
    q = torch.arange(NSUB, device=dev, dtype=torch.int32)
    hit = ((pair_mask[:, None] >> q) & 1) != 0                # (NP, NSUB)
    nhit = hit.sum(1, dtype=torch.int32)
    order = torch.argsort((~hit).to(torch.int32), dim=1, stable=True)
    if nbank > NSUB:
        order = torch.cat([order, order[:, :1].expand(-1, nbank - NSUB)], 1)
    j = torch.arange(nbank, device=dev)
    sel = torch.where(j < nhit[:, None], order[:, :nbank], order[:, :1])
    g = pair_chunk.long()[:, None] * NSUB + sel                # sub-block ids
    n_pairs = g.shape[0]
    banks = records.view(-1, SUB * REC)[g].view(n_pairs, nbank * SUB, REC)
    ids = g[:, :, None] * SUB + torch.arange(SUB, device=dev)
    banks[:, :, REC - 1] = ids.view(n_pairs, nbank * SUB).float()
    return banks, nhit


def tile_centres(tiles: Tensor, ntx: int):
    """Pixel centres (pxf, pyf), each (N, 1024) f32, of the pixels of
    tiles `tiles` (N,) in a row of ntx tiles — the kernels' coordinates."""
    r = torch.arange(TILE_PX, device=tiles.device)
    pxf = (tiles[:, None] % ntx * TILE + r % TILE).float() + 0.5
    pyf = (tiles[:, None] // ntx * TILE + r // TILE).float() + 0.5
    return pxf, pyf


def _tile_cover(rc: Tensor, et: Tensor, ntx: int):
    """(cover, depth), each (B, 16, 1024), of record rows rc (B, 16, 16)
    at every pixel centre of tiles et (B,): the visibility kernels' cover
    test and depth, with their per-op rounding (depth is meaningful where
    cover holds)."""
    px, py = (c[:, None, :] for c in tile_centres(et, ntx))

    def col(k):
        return rc[:, :, k:k + 1]                              # (B,16,1)

    e0 = col(0) * px + col(1) * py + col(2)                   # (B,16,1024)
    e1 = col(3) * px + col(4) * py + col(5)
    e2 = col(6) * px + col(7) * py + col(8)
    zi = (e0 * col(9) + e1 * col(10)) + e2 * col(11)
    wi = (e0 * col(12) + e1 * col(13)) + e2 * col(14)
    cover = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (zi >= 0.0)
             & (zi <= wi) & (wi > 1e-12))
    return cover, zi * (1.0 / wi) + 0.0                       # −0 → +0


def _cover_keys(cover: Tensor, d: Tensor, tid: Tensor,
                depth_only: bool) -> Tensor:
    """One int64 merge key per (candidate, pixel) — depth bits (non-
    negative, so they order like the values) over 0x7FFFFFFF − id, or the
    depth bits alone — and _NO_KEY where the candidate does not cover."""
    key = d.view(torch.int32).long() << 32
    if not depth_only:
        key = key | (0x7FFFFFFF - tid.long())[:, :, None]
    return torch.where(cover, key, _NO_KEY)


def _tile_keys(rc: Tensor, tid: Tensor, et: Tensor, ntx: int,
               depth_only: bool) -> Tensor:
    """The visibility kernels' merge of record rows rc (B, 16, 16) with
    triangle ids tid (B, 16) against every pixel of tiles et (B,): the
    _cover_keys of _tile_cover reduced over the 16 rows with amin:
    (B, 1024)."""
    return _cover_keys(*_tile_cover(rc, et, ntx), tid, depth_only).amin(dim=1)


def _keys_to_frame(keys: Tensor, depth_only: bool):
    depth = (keys >> 32).to(torch.int32).view(torch.float32)
    if depth_only:
        return depth
    return depth, (0x7FFFFFFF - (keys & 0xFFFFFFFF)).to(torch.int32)


def _background_keys(n_tiles: int, depth_only: bool, device) -> Tensor:
    bg = _BG_KEY & ~0xFFFFFFFF if depth_only else _BG_KEY
    return torch.full((n_tiles, TILE_PX), bg, dtype=torch.int64, device=device)


def hit_sub_blocks(bins: Bins, dense: bool = False):
    """(tile, first record row) (E,) i64 each of every hit sub-block of
    every kept pair, in pair order then ascending q; dense takes all 16
    sub-blocks of every kept pair, whatever its mask."""
    dev = bins.records.device
    q = torch.arange(NSUB, device=dev, dtype=torch.int32)
    if dense:
        kept = torch.arange(bins.pair_mask.shape[0], device=dev) < bins.n_real
        hit = kept[:, None].expand(-1, NSUB)
    else:
        hit = ((bins.pair_mask[:, None] >> q) & 1) != 0
    p_idx, q_idx = torch.nonzero(hit, as_tuple=True)
    return (bins.pair_tile[p_idx].long(),
            bins.pair_chunk[p_idx].long() * CHUNK + q_idx * SUB)


def visibility_tiles_plain(bins: Bins, ntx: int, n_tiles: int,
                           batch: int = 2048, depth_only: bool = False,
                           dense: bool = False):
    """Plain PyTorch twin of the visibility kernel: the same triangles
    (every hit sub-block of every kept pair), the same per-op rounding, and
    the same lexicographic merge (_tile_keys). Returns (depth (n_tiles,
    1024) f32, tri (n_tiles, 1024) i32). depth_only (the light pass)
    returns the depth alone. dense (the kbench "nobranch" probe) evaluates
    all 16 sub-blocks of every kept pair, whatever its mask."""
    dev = bins.records.device
    e_tile, e_base = hit_sub_blocks(bins, dense)
    sub = torch.arange(SUB, device=dev)
    keys = _background_keys(n_tiles, depth_only, dev)
    for b in range(0, e_tile.shape[0], batch):
        et, eb = e_tile[b:b + batch], e_base[b:b + batch]
        tid = eb[:, None] + sub                               # (B,16)
        key = _tile_keys(bins.records[tid], tid, et, ntx, depth_only)
        keys.scatter_reduce_(0, et[:, None].expand_as(key), key, "amin")
    return _keys_to_frame(keys, depth_only)


def region_edge_max(rows: Tensor, tiles: Tensor, ntx: int) -> Tensor:
    """(B, 16, 3, N_REGIONS) f32: each edge function of record rows rows
    (B, 16, ≥ 9) at the corner of each warp region of tiles (B,) that
    maximises it — px* = x_hi if a ≥ 0 else x_lo, py* = y_hi if b ≥ 0
    else y_lo — written as the kernel writes it, (a·px + b·py) + c, one
    rounding per op (vis_region_bits in csrc/visibility_common.cuh).
    Rounding is monotone, so this is exactly the edge's maximum over the
    region's pixel centres (NaN where the edge is NaN)."""
    w = torch.arange(N_REGIONS, device=tiles.device)
    col0 = (tiles[:, None] % ntx * TILE + REGION_W * (w % 2))[:, None, :]
    row0 = (tiles[:, None] // ntx * TILE + REGION_H * (w // 2))[:, None, :]
    out = []
    for e in range(3):
        a, b, c = (rows[:, :, 3 * e + i, None] for i in range(3))
        px = (col0 + torch.where(a >= 0.0, REGION_W - 1, 0)).float() + 0.5
        py = (row0 + torch.where(b >= 0.0, REGION_H - 1, 0)).float() + 0.5
        out.append(a * px + b * py + c)                       # (B,16,8)
    return torch.stack(out, dim=2)


def region_keep(rows: Tensor, tiles: Tensor, ntx: int) -> Tensor:
    """(B, 16, N_REGIONS) bool: whether the visibility kernel's warp for
    each region of tiles (B,) evaluates each record row of rows (B, 16,
    ≥ 9) — unless one edge's region_edge_max is < 0, when no pixel centre
    of the region passes that edge. NaN edges are kept; invalid rows
    (e ≡ −1) never are. The plain twin of the kernel's test."""
    return ~(region_edge_max(rows, tiles, ntx) < 0.0).any(dim=2)


def region_kept(bins: Bins, ntx: int, n_tiles: int,
                batch: int = 4096) -> Tensor:
    """(n_tiles,) i64: per tile, the (triangle, region) pairs of its hit
    sub-blocks that region_keep keeps — the visibility kernel's work, 128
    (triangle, pixel) evaluations each."""
    dev = bins.records.device
    e_tile, e_base = hit_sub_blocks(bins)
    sub = torch.arange(SUB, device=dev)
    kept = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    for b in range(0, e_tile.shape[0], batch):
        et = e_tile[b:b + batch]
        rows = bins.records[e_base[b:b + batch, None] + sub]
        kept.index_add_(0, et, region_keep(rows, et, ntx).sum((1, 2)))
    return kept


def visibility_ck_tiles_plain(bins: Bins, ntx: int, n_tiles: int,
                              ck_bank: int, batch: int = 2048):
    """Plain PyTorch twin of the compact-bank kernel, evaluating the bank
    table as the TPU kernel does: every slot of every bank b with
    nhit > b·ck_bank, padding copies included, ids from column 15 →
    (depth, tri) (n_tiles, 1024)."""
    banks = bins.banks
    dev = banks.device
    n_pairs, rows, _ = banks.shape
    nbank = rows // SUB
    runs = -(-bins.nhit.long() // ck_bank) * ck_bank          # slots run
    p_idx, s_idx = torch.nonzero(
        torch.arange(nbank, device=dev) < runs[:, None], as_tuple=True)
    e_tile = bins.pair_tile[p_idx].long()
    slots = banks.view(n_pairs, nbank, SUB, REC)
    keys = _background_keys(n_tiles, False, dev)
    for b in range(0, e_tile.shape[0], batch):
        et = e_tile[b:b + batch]
        rc = slots[p_idx[b:b + batch], s_idx[b:b + batch]]   # (B,16,16)
        key = _tile_keys(rc, rc[:, :, REC - 1].to(torch.int32), et, ntx,
                         False)
        keys.scatter_reduce_(0, et[:, None].expand_as(key), key, "amin")
    return _keys_to_frame(keys, False)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def check_bins(bins: Bins, n_tiles: int) -> None:
    """The kernels' input contract; raises on what they do not take."""
    rec = bins.records
    _require(rec.device.type == "cuda", f"unsupported device {rec.device}")
    _require(rec.dtype == torch.float32 and rec.dim() == 2
             and rec.shape[1] == REC and rec.shape[0] % CHUNK == 0
             and rec.is_contiguous() and rec.data_ptr() % 16 == 0,
             "records must be contiguous, 16-byte aligned (Tpad,16) f32")
    for name in ("pair_chunk", "pair_mask", "tile_start"):
        a = getattr(bins, name)
        _require(a.dtype == torch.int32 and a.is_contiguous()
                 and a.device == rec.device, f"{name} must be contiguous i32 "
                 "on the records' device")
    _require(bins.tile_start.shape[0] == n_tiles + 1,
             "tile_start must have n_tiles + 1 entries")


def visibility_tiles(bins: Bins, ntx: int, n_tiles: int,
                     depth_only: bool = False):
    """Per-tile (depth, tri) for binned triangles: the CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU.
    depth_only returns the light pass's depth alone (visibility_depth_tiles,
    the kernel's depth-only instance)."""
    if depth_only:
        return visibility_depth_tiles(bins, ntx, n_tiles)
    rec = bins.records
    if rec.device.type == "cpu":
        return visibility_tiles_plain(bins, ntx, n_tiles)
    check_bins(bins, n_tiles)
    depth = torch.empty((n_tiles, TILE_PX), dtype=torch.float32,
                        device=rec.device)
    tri = torch.empty((n_tiles, TILE_PX), dtype=torch.int32, device=rec.device)
    fn = _build.kernel("trident_visibility",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 3)
    err = fn(rec.data_ptr(), bins.pair_chunk.data_ptr(),
             bins.pair_mask.data_ptr(), bins.tile_start.data_ptr(), n_tiles,
             ntx, depth.data_ptr(), tri.data_ptr(),
             torch.cuda.current_stream(rec.device).cuda_stream)
    _build.check_launch("trident_visibility", err)
    visibility_tiles.launches += 1
    return depth, tri


visibility_tiles.launches = 0


def visibility_depth_tiles(bins: Bins, ntx: int, n_tiles: int) -> Tensor:
    """Per-tile min depth (n_tiles, 1024) f32 of binned triangles, the
    shadow map's light pass: the depth-only CUDA kernel for tensors on the
    card, the plain version for tensors on the CPU."""
    rec = bins.records
    if rec.device.type == "cpu":
        return visibility_tiles_plain(bins, ntx, n_tiles, depth_only=True)
    check_bins(bins, n_tiles)
    depth = torch.empty((n_tiles, TILE_PX), dtype=torch.float32,
                        device=rec.device)
    fn = _build.kernel("trident_visibility_depth",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 2)
    err = fn(rec.data_ptr(), bins.pair_chunk.data_ptr(),
             bins.pair_mask.data_ptr(), bins.tile_start.data_ptr(), n_tiles,
             ntx, depth.data_ptr(),
             torch.cuda.current_stream(rec.device).cuda_stream)
    _build.check_launch("trident_visibility_depth", err)
    visibility_depth_tiles.launches += 1
    return depth


visibility_depth_tiles.launches = 0


def visibility_ck_tiles(bins: Bins, ntx: int, n_tiles: int, ck_bank: int):
    """Per-tile (depth, tri) from the compact-bank table of
    build_bins(ck_bank=...): the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU. Equal to visibility_tiles on the
    same scene, bit for bit. The kernel stages each pair's first
    min(nhit, 16) slots whatever ck_bank, which shapes the table (and the
    plain version's TPU bank schedule) only."""
    banks = bins.banks
    if banks is None or bins.nhit is None:
        raise ValueError("bins carry no compact-bank table: build them with "
                         "build_bins(ck_bank=...)")
    if banks.device.type == "cpu":
        return visibility_ck_tiles_plain(bins, ntx, n_tiles, ck_bank)
    _require(banks.device.type == "cuda", f"unsupported device {banks.device}")
    nbank = -(-NSUB // ck_bank) * ck_bank
    _require(banks.dtype == torch.float32 and banks.dim() == 3
             and banks.shape[1:] == (nbank * SUB, REC)
             and banks.is_contiguous() and banks.data_ptr() % 16 == 0,
             f"banks must be a contiguous (NP, {nbank * SUB}, 16) f32 table")
    for a in (bins.nhit, bins.tile_start):
        _require(a.dtype == torch.int32 and a.is_contiguous()
                 and a.device == banks.device, "nhit and tile_start must be "
                 "contiguous i32 on the banks' device")
    _require(bins.nhit.shape[0] == banks.shape[0]
             and bins.tile_start.shape[0] == n_tiles + 1,
             "nhit must have one entry per pair, tile_start n_tiles + 1")
    depth = torch.empty((n_tiles, TILE_PX), dtype=torch.float32,
                        device=banks.device)
    tri = torch.empty((n_tiles, TILE_PX), dtype=torch.int32,
                      device=banks.device)
    fn = _build.kernel("trident_visibility_ck",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 3)
    err = fn(banks.data_ptr(), bins.nhit.data_ptr(),
             bins.tile_start.data_ptr(), n_tiles, ntx, ck_bank, nbank,
             depth.data_ptr(), tri.data_ptr(),
             torch.cuda.current_stream(banks.device).cuda_stream)
    _build.check_launch("trident_visibility_ck", err)
    visibility_ck_tiles.launches += 1
    return depth, tri


visibility_ck_tiles.launches = 0


def untile_frame(flat: Tensor, ntx: int, nty: int) -> Tensor:
    """(n_tiles, TILE·TILE) → (nty·TILE, ntx·TILE)."""
    return (flat.reshape(nty, ntx, TILE, TILE).permute(0, 2, 1, 3)
            .reshape(nty * TILE, ntx * TILE))


def untile_channels(flat: Tensor, ntx: int, nty: int) -> Tensor:
    """(n_tiles, C, TILE·TILE) → (nty·TILE, ntx·TILE, C)."""
    ch = flat.shape[1]
    return (flat.reshape(nty, ntx, ch, TILE, TILE).permute(0, 3, 1, 4, 2)
            .reshape(nty * TILE, ntx * TILE, ch))


def visibility(setup: TriangleSetup, width: int, height: int,
               setup_cols: Optional[SetupCols] = None, ck_bank: int = 0,
               **bin_kw) -> GBuffer:
    """Binned visibility → contiguous per-pixel winner id + depth, with
    aux (the untiled visibility of trident_tpu/ops/raster_pallas.py:1443,
    the plane-gather frame's raster). ck_bank > 0 (the ckern knob) runs
    the compact-bank kernel, as the JAX package's visibility does under
    CKERN. `bin_kw` are build_bins' capacities."""
    ntx, nty = -(-width // TILE), -(-height // TILE)
    bins = build_bins(setup, width, height, setup_cols=setup_cols,
                      ck_bank=ck_bank, **bin_kw)
    if ck_bank:
        depth, tri = visibility_ck_tiles(bins, ntx, ntx * nty, ck_bank)
    else:
        depth, tri = visibility_tiles(bins, ntx, ntx * nty)
    return GBuffer(
        tri_id=untile_frame(tri, ntx, nty)[:height, :width].contiguous(),
        depth=untile_frame(depth, ntx, nty)[:height, :width].contiguous(),
        aux=bins.aux)
