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
     depth-only instance renders the shadow map's light pass.

Capacity: sub-blocks whose claim runs past the pool end lose those tiles
and their chunks are counted in aux[1]; pairs past `pair_budget` are
dropped and counted in aux[0]. Overflow drops geometry, never writes
garbage. Tiles no pair touches come out as background (depth 1, id −1)
straight from the kernel, which writes every tile.
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


class Bins(NamedTuple):
    records: Tensor      # (Tpad, 16) f32: e0 e1 e2 as (a,b,c), z(3), w(3), pad
    pair_tile: Tensor    # (NP,) i32 tile per pair, sorted; padding = n_tiles
    pair_chunk: Tensor   # (NP,) i32 chunk per pair (0 on padding)
    pair_mask: Tensor    # (NP,) i32 hit sub-blocks, bit q (0 on padding)
    tile_start: Tensor   # (n_tiles+1,) i32: tile t owns pairs [s[t], s[t+1])
    n_real: Tensor       # () i64 pairs kept (a sorted prefix)
    aux: Tensor          # (2,) i32 [truncated pairs, dropped chunks]


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
        empty = rec.new_tensor([0, 0, -1] * 3 + [0] * 3 + [1] * 3 + [0])
        rec = torch.cat([rec, empty.expand(tpad - t, REC)], dim=0)
    return rec.contiguous()


def build_bins(setup: TriangleSetup, width: int, height: int,
               setup_cols: Optional[SetupCols] = None,
               pool: Optional[int] = None,
               pair_budget: Optional[int] = None) -> Bins:
    """Bin triangles to 32×32 tiles for a width × height target. `pool`
    (emission slots) and `pair_budget` (kept pairs) are capacities;
    overflow is counted in aux, see the module note."""
    dev = setup.valid.device
    t = setup.valid.shape[0]
    n_chunks = max(1, -(-t // CHUNK))
    tpad = n_chunks * CHUNK
    n_sub = n_chunks * NSUB
    ntx, nty = -(-width // TILE), -(-height // TILE)
    n_tiles = ntx * nty
    if pool is None:
        pool = default_pool(n_sub, n_tiles)
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
    return Bins(records=records,
                pair_tile=pair_tile.to(torch.int32),
                pair_chunk=(pair_key % n_chunks).to(torch.int32),
                pair_mask=pair_mask.to(torch.int32),
                tile_start=tile_start.to(torch.int32),
                n_real=n_real,
                aux=torch.stack([n_real_total - n_real,
                                 n_dropped]).to(torch.int32))


def visibility_tiles_plain(bins: Bins, ntx: int, n_tiles: int,
                           batch: int = 2048, depth_only: bool = False):
    """Plain PyTorch twin of the visibility kernel: the same triangles
    (every hit sub-block of every kept pair), the same per-op rounding, and
    the same lexicographic merge, expressed as an int64 key per candidate
    — depth bits (non-negative, so they order like the values) over
    0x7FFFFFFF − id — reduced with amin. Returns (depth (n_tiles, 1024)
    f32, tri (n_tiles, 1024) i32). depth_only (the light pass) drops the
    id half of the key and returns the depth alone."""
    dev = bins.records.device
    q = torch.arange(NSUB, device=dev, dtype=torch.int32)
    hit = ((bins.pair_mask[:, None] >> q) & 1) != 0
    p_idx, q_idx = torch.nonzero(hit, as_tuple=True)
    e_tile = bins.pair_tile[p_idx].long()
    e_base = bins.pair_chunk[p_idx].long() * CHUNK + q_idx * SUB
    r = torch.arange(TILE_PX, device=dev)
    lx, ly = r % TILE, r // TILE
    sub = torch.arange(SUB, device=dev)
    bg = _BG_KEY & ~0xFFFFFFFF if depth_only else _BG_KEY
    keys = torch.full((n_tiles, TILE_PX), bg, dtype=torch.int64, device=dev)
    for b in range(0, e_tile.shape[0], batch):
        et, eb = e_tile[b:b + batch], e_base[b:b + batch]
        tid = eb[:, None] + sub                               # (B,16)
        rc = bins.records[tid]                                # (B,16,16)
        px = ((et % ntx * TILE)[:, None] + lx).float()[:, None, :] + 0.5
        py = ((et // ntx * TILE)[:, None] + ly).float()[:, None, :] + 0.5

        def col(k):
            return rc[:, :, k:k + 1]                          # (B,16,1)

        e0 = col(0) * px + col(1) * py + col(2)               # (B,16,1024)
        e1 = col(3) * px + col(4) * py + col(5)
        e2 = col(6) * px + col(7) * py + col(8)
        zi = (e0 * col(9) + e1 * col(10)) + e2 * col(11)
        wi = (e0 * col(12) + e1 * col(13)) + e2 * col(14)
        cover = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (zi >= 0.0)
                 & (zi <= wi) & (wi > 1e-12))
        d = zi * (1.0 / wi) + 0.0                             # −0 → +0
        key = d.view(torch.int32).long() << 32
        if not depth_only:
            key = key | (0x7FFFFFFF - tid)[:, :, None]
        key = torch.where(cover, key, _NO_KEY).amin(dim=1)    # (B,1024)
        keys.scatter_reduce_(0, et[:, None].expand_as(key), key, "amin")
    depth = (keys >> 32).to(torch.int32).view(torch.float32)
    if depth_only:
        return depth
    tri = (0x7FFFFFFF - (keys & 0xFFFFFFFF)).to(torch.int32)
    return depth, tri


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_bins(bins: Bins, n_tiles: int) -> None:
    """The kernels' input contract; raises on what they do not take."""
    rec = bins.records
    _require(rec.device.type == "cuda", f"unsupported device {rec.device}")
    _require(rec.dtype == torch.float32 and rec.dim() == 2
             and rec.shape[1] == REC and rec.shape[0] % CHUNK == 0
             and rec.is_contiguous(), "records must be contiguous (Tpad,16) f32")
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
    _check_bins(bins, n_tiles)
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
    _check_bins(bins, n_tiles)
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


def untile_frame(flat: Tensor, ntx: int, nty: int) -> Tensor:
    """(n_tiles, TILE·TILE) → (nty·TILE, ntx·TILE)."""
    return (flat.reshape(nty, ntx, TILE, TILE).permute(0, 2, 1, 3)
            .reshape(nty * TILE, ntx * TILE))


def visibility(setup: TriangleSetup, width: int, height: int,
               setup_cols: Optional[SetupCols] = None, **bin_kw) -> GBuffer:
    """Binned visibility → contiguous per-pixel winner id + depth, with
    aux. `bin_kw` are build_bins' capacities."""
    ntx, nty = -(-width // TILE), -(-height // TILE)
    bins = build_bins(setup, width, height, setup_cols=setup_cols, **bin_kw)
    depth, tri = visibility_tiles(bins, ntx, ntx * nty)
    return GBuffer(
        tri_id=untile_frame(tri, ntx, nty)[:height, :width].contiguous(),
        depth=untile_frame(depth, ntx, nty)[:height, :width].contiguous(),
        aux=bins.aux)
