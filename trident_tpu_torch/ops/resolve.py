"""Attribute resolve: per-pixel winner ids → the 16 shading channels.

Port of trident_tpu/ops/resolve_pallas.py (the channel layout, the
interpolant math, the resolve pass as one kernel, csrc/resolve.cu, in its
(H, W) and tiled layouts, and the fused visibility + resolve pass of the
`fuse` knob, csrc/visibility_resolve.cu). On the TPU the winner's record
row was selected with one-hot matrix products over the visibility pass's
pair list; on the card it is a direct load of row tri_id of the
row-major (T, RR_WIDTH) record table (ops/planes.py): one 128-byte line.
With vertex colours the table is (T, RR_WIDTH_VCOLOR), 160-byte rows, and
each kernel runs its 40-wide instance, which multiplies the colour
factor's rgb by the interpolated vertex colour (the `vertex_colors=True`
branch of _eval_interpolants). Every entry point takes only a contiguous
(T, RW) f32 table with a 16-byte-aligned base on the ids' device, RW a
width it has an instance for, and raises on anything else.

One band of a taller frame (the banded multi-device frame, parallel/
framebuffer.py) resolves its rows at their global pixel centres: the
(H, W) entry point takes `y_offset` (the band's first global row), the
tiled and fused ones `tile_y_offset` (whole tiles); an offset, 0
included, launches the kernels' band instances, None the offset-free
ones.

`prec` is the `resolve_prec` knob. "split" and "fp32" are the exact
instances above (on the TPU they are two exact precision strategies of
the winner select; on the card there is no select to be inexact). "bf16"
takes the bf16 instance of the same layout, width and band form: on the
TPU that mode contracts the f32 records in one raw bf16 pass, so every
record word the winner's pixels read is rounded to bf16; the kernels
round each word as they load it, and the plain versions round the whole
table once (bf16_records), which commutes with the select.

Each entry point names its instance in one place (_instance: the table's
width, the band form and `prec`) and launches it through _build.launch,
which counts it by that name.
"""

from __future__ import annotations

import ctypes

import torch

from typing import Optional

from trident_tpu_torch import _build
from trident_tpu_torch.ops import planes as P
from trident_tpu_torch.ops import raster

Tensor = torch.Tensor

# attribute-image channel layout (CHANNELS = 16)
CH_NX, CH_NY, CH_NZ = 0, 1, 2    # world normal (unnormalized)
CH_U, CH_V = 3, 4                # atlas-transformed UV
CH_MIP = 5                       # trilinear mip level
CH_CF = 6                        # color factor rgba → 6..9
CH_MET, CH_ROUGH, CH_AMB = 10, 11, 12
CH_BASE8 = 13                    # texture flat base >> 8 (f32-exact)
CH_TSX, CH_TSY = 14, 15          # mip-0 texture (w, h)
CHANNELS = 16


def eval_interpolants(sel: Tensor, pxf: Tensor, pyf: Tensor,
                      vertex_colors: bool = False) -> Tensor:
    """Every shading interpolant from selected records `sel` (RW, N) (the
    transposed (N, RW) rows the plain versions gather: sel[j] is field j) at
    pixel centres (pxf, pyf) (N,) → (CHANNELS, N) f32. Same expressions, in
    the same order, as resolve_pallas._eval_interpolants; with
    `vertex_colors` the colour factor's rgb is multiplied by the
    perspective-correct vertex colour (RW = RR_WIDTH_VCOLOR)."""

    def row(j):
        return sel[j]

    def plane(j):                              # g·(px, py, 1)
        return row(j) * pxf + row(j + 1) * pyf + row(j + 2)

    denom = plane(P.RR_G1)
    inv = 1.0 / torch.where(denom.abs() < 1e-20, 1e-20, denom)
    nx = plane(P.RR_NX) * inv
    ny = plane(P.RR_NY) * inv
    nz = plane(P.RR_NZ) * inv
    u = plane(P.RR_U) * inv
    v = plane(P.RR_V) * inv

    # analytic UV screen derivatives → mip
    g1x, g1y = row(P.RR_G1), row(P.RR_G1 + 1)
    du_dx = (row(P.RR_U) - u * g1x) * inv
    du_dy = (row(P.RR_U + 1) - u * g1y) * inv
    dv_dx = (row(P.RR_V) - v * g1x) * inv
    dv_dy = (row(P.RR_V + 1) - v * g1y) * inv
    tsx, tsy = row(P.RR_TSX), row(P.RR_TSY)
    ax, bx = du_dx * tsx, dv_dx * tsy
    ay, by = du_dy * tsx, dv_dy * tsy
    rho = torch.maximum(ax * ax + bx * bx, ay * ay + by * by)
    mip = 0.5 * torch.log2(torch.clamp_min(rho, 1e-12))

    cf_r, cf_g, cf_b = row(P.RR_CF), row(P.RR_CF + 1), row(P.RR_CF + 2)
    if vertex_colors:
        cf_r = cf_r * plane(P.RR_COL) * inv
        cf_g = cf_g * plane(P.RR_COL + 3) * inv
        cf_b = cf_b * plane(P.RR_COL + 6) * inv

    return torch.stack([
        nx, ny, nz, u, v, mip,
        cf_r, cf_g, cf_b, row(P.RR_CF + 3),
        row(P.RR_MET), row(P.RR_ROUGH), row(P.RR_AMB), row(P.RR_BASE8),
        tsx, tsy,
    ], dim=0)


WIDTHS = (P.RR_WIDTH, P.RR_WIDTH_VCOLOR)
PRECS = ("split", "fp32", "bf16")      # the resolve_prec knob's values


def bf16_records(records: Tensor) -> Tensor:
    """The record table with every word rounded to bf16 (nearest-even)
    and back to f32: what the bf16 instances read."""
    return records.to(torch.bfloat16).float()


def _check_records(records: Tensor, device, widths=WIDTHS) -> bool:
    """Raise unless `records` is a contiguous (T, RW) f32 table, RW one of
    `widths`, with a 16-byte-aligned base on `device` (each row RW / 4
    aligned float4s). Returns whether it carries vertex colours."""
    if (records.device != device or records.dtype != torch.float32
            or records.dim() != 2 or records.shape[1] not in widths
            or not records.is_contiguous() or records.data_ptr() % 16):
        shapes = " or ".join(f"(T, {w})" for w in widths)
        raise ValueError(f"records must be a contiguous {shapes} f32 table "
                         "with a 16-byte-aligned base on the ids' device")
    return records.shape[1] == P.RR_WIDTH_VCOLOR


def _winner_rows(records: Tensor, flat: Tensor) -> Tensor:
    """The winners' records as (RW, N) fields (uncovered ids read row 0)."""
    return records[flat.clamp_min(0).long()].T


def _vc(records: Tensor) -> bool:
    return records.shape[1] == P.RR_WIDTH_VCOLOR


def _instance(base: str, vc: bool, offset: Optional[int], prec: str) -> str:
    """The entry point of kernel `base`'s instance for a table with
    vertex colours (`vc`), a band's first row or tile row `offset` (None:
    no band) and resolve_prec `prec`."""
    return (base + "_vc" * vc + "_band" * (offset is not None)
            + "_bf16" * (prec == "bf16"))


def _table(records: Tensor, prec: str) -> Tensor:
    """What the plain versions read for resolve_prec `prec`."""
    return bf16_records(records) if prec == "bf16" else records


def resolve_attrs_plain(tri_id: Tensor, records: Tensor,
                        y_offset: int = 0) -> Tensor:
    """Plain PyTorch twin of the resolve kernel (both widths): (H, W)
    winner ids and the (T, RW) records → (H, W, CHANNELS) f32, zeros where
    tri_id < 0; row r's pixel centres lie on global row r + y_offset (a
    band's)."""
    h, w = tri_id.shape
    dev = tri_id.device
    flat = tri_id.reshape(-1)
    sel = _winner_rows(records, flat)                        # (RW, H·W)
    ys = (torch.arange(h, device=dev) + y_offset).float() + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    pyf = ys[:, None].expand(h, w).reshape(-1)
    pxf = xs[None, :].expand(h, w).reshape(-1)
    attrs = eval_interpolants(sel, pxf, pyf, _vc(records)).T  # (H·W, CH)
    attrs = torch.where((flat >= 0)[:, None], attrs, 0.0)
    return attrs.reshape(h, w, CHANNELS)


def resolve_attrs(tri_id: Tensor, records: Tensor,
                  y_offset: Optional[int] = None,
                  prec: str = "split") -> Tensor:
    """(H, W, CHANNELS) attribute image of (H, W) winner ids: the CUDA
    kernel's instance for the table's width, the band form (a y_offset:
    the ids are one band's) and `prec` for tensors on the card, the plain
    version (on the bf16-rounded table for prec "bf16") for tensors on
    the CPU."""
    vc = _check_records(records, tri_id.device)
    if tri_id.device.type == "cpu":
        return resolve_attrs_plain(tri_id, _table(records, prec),
                                   y_offset or 0)
    if tri_id.device.type != "cuda":
        raise ValueError(f"unsupported device {tri_id.device}")
    if tri_id.dtype != torch.int32 or tri_id.dim() != 2 \
            or not tri_id.is_contiguous():
        raise ValueError("tri_id must be a contiguous (H, W) i32 tensor")
    h, w = tri_id.shape
    band = () if y_offset is None else (int(y_offset),)
    out = torch.empty((h, w, CHANNELS), dtype=torch.float32,
                      device=tri_id.device)
    _build.launch(_instance("trident_resolve", vc, y_offset, prec),
                  [ctypes.c_void_p] * 2 + [ctypes.c_int] * (2 + len(band))
                  + [ctypes.c_void_p], tri_id.device,
                  tri_id.data_ptr(), records.data_ptr(), w, h, *band,
                  out.data_ptr())
    return out


def resolve_attrs_tiled_plain(tri_tiles: Tensor, records: Tensor,
                              ntx: int, tile_y_offset: int = 0) -> Tensor:
    """Plain PyTorch twin of the tiled resolve kernel: (n_tiles, 1024)
    winner ids in tile layout → (n_tiles, CHANNELS, 1024) f32, zeros
    where tri < 0 — the (H, W) resolve's values, permuted; tile rows from
    global tile row tile_y_offset (a band's)."""
    n_tiles = tri_tiles.shape[0]
    flat = tri_tiles.reshape(-1)
    pxf, pyf = raster.tile_centres(
        torch.arange(n_tiles, device=tri_tiles.device), ntx, tile_y_offset)
    attrs = eval_interpolants(_winner_rows(records, flat),
                              pxf.reshape(-1), pyf.reshape(-1),
                              _vc(records))
    attrs = torch.where(flat >= 0, attrs, 0.0)               # (CH, N)
    return attrs.view(CHANNELS, n_tiles, raster.TILE_PX).permute(1, 0, 2) \
        .contiguous()


def resolve_attrs_tiled(tri_tiles: Tensor, records: Tensor, ntx: int,
                        tile_y_offset: Optional[int] = None,
                        prec: str = "split") -> Tensor:
    """(n_tiles, CHANNELS, 1024) attributes of (n_tiles, 1024) tile-layout
    winner ids (resolve_attrs_pallas(tiled=True)): the CUDA kernel's
    instance for the table's width, the band form (a tile_y_offset: one
    band's tiles) and `prec` for tensors on the card, the plain version
    (on the bf16-rounded table for prec "bf16") for tensors on the CPU."""
    vc = _check_records(records, tri_tiles.device)
    if tri_tiles.device.type == "cpu":
        return resolve_attrs_tiled_plain(tri_tiles, _table(records, prec),
                                         ntx, tile_y_offset or 0)
    if tri_tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tri_tiles.device}")
    if (tri_tiles.dtype != torch.int32 or tri_tiles.dim() != 2
            or tri_tiles.shape[1] != raster.TILE_PX
            or not tri_tiles.is_contiguous()):
        raise ValueError("tri_tiles must be a contiguous (n_tiles, 1024) i32 "
                         "tensor")
    n_tiles = tri_tiles.shape[0]
    band = () if tile_y_offset is None else (int(tile_y_offset),)
    out = torch.empty((n_tiles, CHANNELS, raster.TILE_PX),
                      dtype=torch.float32, device=tri_tiles.device)
    _build.launch(_instance("trident_resolve_tiled", vc, tile_y_offset, prec),
                  [ctypes.c_void_p] * 2 + [ctypes.c_int] * (2 + len(band))
                  + [ctypes.c_void_p], tri_tiles.device,
                  tri_tiles.data_ptr(), records.data_ptr(), ntx, n_tiles,
                  *band, out.data_ptr())
    return out


def fused_visibility_resolve_plain(bins: raster.Bins, records: Tensor,
                                   ntx: int, n_tiles: int,
                                   tile_y_offset: int = 0):
    """Plain PyTorch twin of the fused kernel: visibility_tiles_plain, then
    resolve_attrs_tiled_plain on its winners → (depth, tri) (n_tiles,
    1024) and attrs (n_tiles, CHANNELS, 1024); tile rows from global tile
    row tile_y_offset (a band's)."""
    depth, tri = raster.visibility_tiles_plain(bins, ntx, n_tiles,
                                               tile_y_offset=tile_y_offset)
    return depth, tri, resolve_attrs_tiled_plain(tri, records, ntx,
                                                 tile_y_offset)


def fused_visibility_resolve(bins: raster.Bins, records: Tensor, ntx: int,
                             n_tiles: int,
                             tile_y_offset: Optional[int] = None,
                             prec: str = "split"):
    """Visibility and resolve in one pass over the bins (the `fuse` knob,
    fused_visibility_resolve_pallas): (depth, tri) (n_tiles, 1024) and
    attrs (n_tiles, CHANNELS, 1024), equal to visibility_tiles followed by
    resolve_attrs_tiled. The CUDA kernel's instance for the table's width,
    the band form (a tile_y_offset: one band) and `prec` for tensors on
    the card (with prec "bf16" depth and ids are K1's, the attributes
    those of the bf16-rounded records), the plain version (on the
    bf16-rounded table for prec "bf16") for tensors on the CPU."""
    rec = bins.records
    vc = _check_records(records, rec.device)
    if rec.device.type == "cpu":
        return fused_visibility_resolve_plain(bins, _table(records, prec),
                                              ntx, n_tiles, tile_y_offset or 0)
    raster.check_bins(bins, n_tiles)
    band = () if tile_y_offset is None else (int(tile_y_offset),)
    depth = torch.empty((n_tiles, raster.TILE_PX), dtype=torch.float32,
                        device=rec.device)
    tri = torch.empty((n_tiles, raster.TILE_PX), dtype=torch.int32,
                      device=rec.device)
    attrs = torch.empty((n_tiles, CHANNELS, raster.TILE_PX),
                        dtype=torch.float32, device=rec.device)
    _build.launch(_instance("trident_visibility_resolve", vc, tile_y_offset,
                            prec),
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * (2 + len(band))
                  + [ctypes.c_void_p] * 4, rec.device,
                  rec.data_ptr(), bins.pair_chunk.data_ptr(),
                  bins.pair_mask.data_ptr(), bins.tile_start.data_ptr(),
                  n_tiles, ntx, *band, records.data_ptr(), depth.data_ptr(),
                  tri.data_ptr(), attrs.data_ptr())
    return depth, tri, attrs
