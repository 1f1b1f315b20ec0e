"""Visibility-kernel cost decomposition on the card: the port's
counterpart of the JAX package's tools_dev/kbench.py (its round-4 TPU
runs r4hw1 and r5hw2 asked the same questions of the Pallas kernel).

    python3 -m trident_tpu_torch.tools_dev.kbench \\
        --configs zero,dflt,full,nobranch,dual,probe,probe_tiny --bins --sort
    python3 -m trident_tpu_torch.tools_dev.kbench --device cpu --grid 1 \\
        --configs zero,dflt,probe_tiny      # a CPU rehearsal: plain versions

It times the bare visibility kernel (csrc/visibility.cu, K1) on
spheres1080_1m's real bins (bench.py's 36×36 sphere grid at 1920×1080, at
the rotation chip_smoke.py's phase 3 renders) under doctored masks, and
the probe kernels of csrc/visibility_probe.cu:

  zero        every mask bit cleared: the per-pair walk alone (K1 stages
              nothing and syncs twice per pair)
  dflt        the real masks
  full        all 16 bits set on the real pairs: the walk and 16 staged
              sub-blocks per pair (the frame also gains the rounding hits
              that the binner's bbox cull drops, bbox_culled_hits)
  nobranch    every sub-block staged straight-line, no mask walk
              (trident_visibility_dense, K1's region design on all 16
              sub-blocks): full − nobranch is the mask walk's cost, and
              the two frames are equal
  dual        dflt plus a co-streamed resolve-shaped second table, the
              port's (32, Tpad) f32 resolve-record layout, all zeros
              (trident_visibility_dual, K1's region design): dual − dflt
              is the cost of a second streamed operand
  probe       the walk plus each pair's 16 KB record block fetched but not
              evaluated (trident_visibility_reset)
  probe_tiny  the same with a 4 KB block of an (nblk·8, 128) dummy table

so (full − zero)/16 is the per-sub-block cost, probe − probe_tiny the
record fetch and zero − probe_tiny the walk without the record traffic.
Each config prints its CUDA-event median and device-busy ms and the card.
--kernel ckern runs zero/dflt/full through the compact-bank kernel
(csrc/visibility_ck.cu: the same region design, each pair's live bank
slots staged by one bulk copy into a double-buffered ring, so its dflt
beside K1's is a staging A/B on the same kept pairs) on bins built with
ck_bank 8, the bank table rebuilt from the doctored masks, and skips
nobranch and dual, as the JAX script does under CKERN. --bins splits
build_bins' time (records, emission + sort, one pool-sized sort) and
--sort runs a ladder of torch.sort sizes; --records times the resolve
table's producer, the (T, 32) rows frame_geometry builds against the
(32, T) column layout the port built before (stack, then pad), alone and
inside frame_geometry, in the order rows, columns, columns, rows. The
three legs are plain PyTorch, no kernel.

Deviation from the JAX script: it builds the bins through the indexed
vertex_stage + triangle_setup (kbench.py:59-67); the port has no indexed
rigid path (the JAX Renderer takes it only for skinned meshes,
trident_tpu/render/renderer.py:258,284-292), so the bins here come as the
port's frame builds them: frame_inputs → frame_geometry (corner stage) →
raster.build_bins.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from trident_tpu_torch import _build, resolve_device
from trident_tpu_torch.ops import planes, raster
from trident_tpu_torch.ops.planes import RR_WIDTH
from trident_tpu_torch.tools_dev.timing import card, fmt_ms, timed, timed_ms

Tensor = torch.Tensor

CONFIGS = ("zero", "dflt", "full", "nobranch", "dual", "probe", "probe_tiny")
DEFAULT_CONFIGS = "zero,dflt,full,nobranch,dflt"   # kbench.py:404-405
CK_BANK = 8                                        # the JAX default ck_bank
TINY_ROWS, TINY_LANES = 8, 128                     # probe_tiny's block
SORT_LADDER = (8192, 16384, 24576, 32768, 49152, 65536, 73664, 81920, 98304,
               131072)                             # kbench.py:343-344


def frame_bins(r, ck_bank: int = 0):
    """(corner stage output, (T, RW) resolve records, bins, width, height)
    of Renderer r's current frame, as its render_frame builds them
    (chip_smoke.py phase 3); ck_bank > 0 adds the compact-bank table."""
    from trident_tpu_torch.render.renderer import frame_geometry

    rc = r.config.render
    r.editor_camera.set_viewport_size(rc.width, rc.height)
    inp = r.frame_inputs()
    w, h = inp["width"], inp["height"]
    cs, records = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"], width=w, height=h,
        draw_stride=inp["draw_stride"], real_draws=inp["real_draws"])
    bins = raster.build_bins(cs.setup, w, h, setup_cols=cs.cols.setup,
                             ck_bank=ck_bank)
    return cs, records, bins, w, h


def hit_total(bins: raster.Bins) -> int:
    """Hit sub-blocks over all kept pairs (padding pairs have mask 0)."""
    q = torch.arange(raster.NSUB, device=bins.pair_mask.device)
    return int(((bins.pair_mask[:, None] >> q) & 1).sum())


def report_bins(bins: raster.Bins) -> None:
    """kbench.py:68-87's line: pairs, aux and the hit sub-blocks."""
    n, hits = int(bins.n_real), hit_total(bins)
    print(f"pairs={n} aux={bins.aux.tolist()} hit_total={hits} "
          f"({hits / max(n, 1):.1f}/pair of {raster.NSUB})", flush=True)


def doctored(bins: raster.Bins, kind: str, ck_bank: int = 0) -> raster.Bins:
    """kbench.py:89-112 on the port's 16-bit masks: "zero" clears every
    mask, "full" sets all 16 bits on the real pairs (arange(NP) < n_real)
    and leaves padding at 0, "dflt" returns the bins. With ck_bank the
    compact-bank table and nhit are rebuilt from the doctored masks."""
    if kind == "dflt":
        return bins
    if kind not in ("zero", "full"):
        raise ValueError(f"unknown mask doctoring {kind!r}")
    dev = bins.pair_mask.device
    real = torch.arange(bins.pair_mask.shape[0], device=dev) < bins.n_real
    value = (1 << raster.NSUB) - 1 if kind == "full" else 0
    mask = torch.where(real, value, 0).to(torch.int32)
    banks = nhit = None
    if ck_bank:
        banks, nhit = raster._ck_banks(bins.records, bins.pair_chunk, mask,
                                       ck_bank)
    return bins._replace(pair_mask=mask, banks=banks, nhit=nhit)


def bbox_culled_hits(setup, depth: Tensor, tri: Tensor, ref_depth: Tensor,
                     ref_tri: Tensor, ntx: int):
    """(differing pixels, unexplained ones) of per-tile (depth, tri) from
    more sub-blocks than the binner marked (full, nobranch) against the
    binned frame (ref_depth, ref_tri). The cover test admits rounding hits
    on the extension of a near-degenerate triangle, outside its bbox; the
    binner's bbox cull drops them. A difference is explained when its
    winner is such a hit: a triangle whose bbox excludes the pixel, beating
    the binned winner in the (min depth, max id) order."""
    diff = (tri != ref_tri) | (depth.view(torch.int32)
                               != ref_depth.view(torch.int32))
    tiles, r = diff.nonzero(as_tuple=True)
    x = tiles % ntx * raster.TILE + r % raster.TILE
    y = tiles // ntx * raster.TILE + r // raster.TILE
    win, ref = tri[tiles, r], ref_tri[tiles, r]
    d, rd = depth[tiles, r], ref_depth[tiles, r]
    bb = setup.bbox[win.clamp(min=0).long()]
    inside = ((x >= bb[:, 0]) & (x < bb[:, 2]) & (y >= bb[:, 1])
              & (y < bb[:, 3]))
    beats = (d < rd) | ((d == rd) & (win > ref))
    explained = (win >= 0) & ~inside & beats
    return int(tiles.numel()), int((~explained).sum())


def bbox_pixel_pairs(bins: raster.Bins, setup, ntx: int) -> int:
    """The (triangle, pixel) pairs of the hit sub-blocks whose pixel centre
    lies in the triangle's bbox, clipped to the pair's tile: a lower
    estimate of the pairs any exact visibility kernel evaluates on these
    bins, whatever its thread map or reject test. The bbox is that of the
    vertices (each the cross product of two edge rows, in f64), within the
    binner's setup.bbox; a triangle with a vertex at w ≤ 1e-6, or whose
    vertices do not come out finite, keeps setup.bbox."""
    e = setup.edge.double()
    v = torch.stack([torch.linalg.cross(e[:, j], e[:, k])
                     for j, k in ((1, 2), (2, 0), (0, 1))], dim=1)
    x, y = v[..., 0] / v[..., 2], v[..., 1] / v[..., 2]        # (T, 3)
    exact = (torch.isfinite(x).all(1) & torch.isfinite(y).all(1)
             & ~(setup.w <= 1e-6).any(1))
    bb = setup.bbox.long()

    def clip(lo, hi, c0, c1):
        lo = torch.where(exact, torch.ceil(lo.nan_to_num(0.0) - 0.5).clamp(
            -1 << 20, 1 << 20).long(), bb[:, c0])
        hi = torch.where(exact, torch.floor(hi.nan_to_num(0.0) - 0.5).clamp(
            -1 << 20, 1 << 20).long() + 1, bb[:, c1])
        return torch.maximum(lo, bb[:, c0]), torch.minimum(hi, bb[:, c1])

    x0, x1 = clip(x.amin(1), x.amax(1), 0, 2)
    y0, y1 = clip(y.amin(1), y.amax(1), 1, 3)
    e_tile, e_base = raster.hit_sub_blocks(bins)
    tid = e_base[:, None] + torch.arange(raster.SUB, device=e_base.device)
    real = tid < setup.valid.shape[0]
    t = tid.clamp(max=setup.valid.shape[0] - 1)
    tx = (e_tile % ntx * raster.TILE)[:, None]
    ty = (e_tile // ntx * raster.TILE)[:, None]
    w = (torch.minimum(x1[t], tx + raster.TILE)
         - torch.maximum(x0[t], tx)).clamp(min=0)
    h = (torch.minimum(y1[t], ty + raster.TILE)
         - torch.maximum(y0[t], ty)).clamp(min=0)
    return int(torch.where(real & setup.valid[t], w * h, 0).sum())


def _tile_outputs(n_tiles: int, dev):
    return (torch.empty((n_tiles, raster.TILE_PX), dtype=torch.float32,
                        device=dev),
            torch.empty((n_tiles, raster.TILE_PX), dtype=torch.int32,
                        device=dev))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def visibility_dense(bins: raster.Bins, ntx: int, n_tiles: int):
    """Per-tile (depth, tri) with every sub-block of every kept pair
    evaluated ("nobranch"): the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU. Equal to visibility_tiles on
    "full" masks; against the real masks it also keeps the rounding hits
    that the binner culls (bbox_culled_hits)."""
    rec = bins.records
    if rec.device.type == "cpu":
        return raster.visibility_tiles_plain(bins, ntx, n_tiles, dense=True)
    raster.check_bins(bins, n_tiles)
    depth, tri = _tile_outputs(n_tiles, rec.device)
    fn = _build.kernel("trident_visibility_dense",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 3)
    err = fn(rec.data_ptr(), bins.pair_chunk.data_ptr(),
             bins.pair_mask.data_ptr(), bins.tile_start.data_ptr(), n_tiles,
             ntx, depth.data_ptr(), tri.data_ptr(), _stream(rec.device))
    _build.check_launch("trident_visibility_dense", err)
    visibility_dense.launches += 1
    return depth, tri


visibility_dense.launches = 0


def dual_table(bins: raster.Bins) -> Tensor:
    """dual's second operand: zeros in the port's resolve-record layout,
    (RR_WIDTH, Tpad) f32 — one 32 KB strip per pair chunk."""
    return torch.zeros((RR_WIDTH, bins.records.shape[0]), dtype=torch.float32,
                       device=bins.records.device)


def visibility_dual_plain(bins: raster.Bins, table2: Tensor, ntx: int,
                          n_tiles: int):
    """Plain twin of the dual kernel: K1's plain version, then each tile's
    depth plus 1e-30 × the sum of its pairs' strips of table2. The kernel
    sums in another order, so the two agree bit for bit where the sums are
    exact (the zero table of the probe)."""
    depth, tri = raster.visibility_tiles_plain(bins, ntx, n_tiles)
    dev = table2.device
    strips = table2.view(table2.shape[0], -1, raster.CHUNK).sum(dim=(0, 2))
    kept = torch.arange(bins.pair_chunk.shape[0], device=dev) < bins.n_real
    per_pair = torch.where(kept, strips[bins.pair_chunk.long()], 0.0)
    tile_sum = torch.zeros(n_tiles + 1, dtype=torch.float32, device=dev)
    tile_sum.index_add_(0, bins.pair_tile.long().clamp(max=n_tiles), per_pair)
    return depth + 1e-30 * tile_sum[:n_tiles, None], tri


def visibility_dual(bins: raster.Bins, table2: Tensor, ntx: int,
                    n_tiles: int):
    """Per-tile (depth, tri) of K1 with each pair chunk's strip of table2
    (rows ≤ 32, Tpad) f32 streamed beside it and 1e-30 × the tile's strip
    sum added to its depths ("dual"): the CUDA kernel for tensors on the
    card, the plain version for tensors on the CPU."""
    rec = bins.records
    if rec.device.type == "cpu":
        return visibility_dual_plain(bins, table2, ntx, n_tiles)
    raster.check_bins(bins, n_tiles)
    raster._require(table2.dtype == torch.float32 and table2.dim() == 2
                    and table2.shape[0] <= RR_WIDTH
                    and table2.shape[1] == rec.shape[0]
                    and table2.is_contiguous() and table2.device == rec.device
                    and table2.data_ptr() % 16 == 0,
                    "table2 must be a contiguous (≤ 32, Tpad) f32 table on "
                    "the records' device")
    depth, tri = _tile_outputs(n_tiles, rec.device)
    fn = _build.kernel("trident_visibility_dual",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3)
    err = fn(rec.data_ptr(), bins.pair_chunk.data_ptr(),
             bins.pair_mask.data_ptr(), bins.tile_start.data_ptr(), n_tiles,
             ntx, table2.data_ptr(), table2.shape[0], table2.shape[1],
             depth.data_ptr(), tri.data_ptr(), _stream(rec.device))
    _build.check_launch("trident_visibility_dual", err)
    visibility_dual.launches += 1
    return depth, tri


visibility_dual.launches = 0


def probe_table(bins: raster.Bins, tiny: bool):
    """(table, block_floats) of the reset probe: the records' 256 × 16
    block per chunk (probe), or one (8, 128) block per chunk of a zero
    (nblk·8, 128) dummy table (probe_tiny, kbench.py:369-375)."""
    rec = bins.records
    if not tiny:
        return rec, raster.CHUNK * raster.REC
    nblk = rec.shape[0] // raster.CHUNK
    return (torch.zeros((nblk * TINY_ROWS, TINY_LANES), dtype=torch.float32,
                        device=rec.device), TINY_ROWS * TINY_LANES)


def visibility_reset_plain(bins: raster.Bins, n_tiles: int):
    """Plain twin of the reset probe: background (depth 1, id −1)."""
    dev = bins.records.device
    return (torch.ones((n_tiles, raster.TILE_PX), dtype=torch.float32,
                       device=dev),
            torch.full((n_tiles, raster.TILE_PX), -1, dtype=torch.int32,
                       device=dev))


def visibility_reset(bins: raster.Bins, table: Tensor, block_floats: int,
                     n_tiles: int):
    """The walk with each pair's block of `table` (block_floats floats at
    block index pair_chunk) fetched and folded but not evaluated ("probe",
    "probe_tiny"); every pixel background: the CUDA kernel for tensors on
    the card, the plain version for tensors on the CPU."""
    rec = bins.records
    if rec.device.type == "cpu":
        return visibility_reset_plain(bins, n_tiles)
    raster.check_bins(bins, n_tiles)
    raster._require(table.dtype == torch.float32 and table.is_contiguous()
                    and table.device == rec.device
                    and table.data_ptr() % 16 == 0 and block_floats > 0
                    and block_floats % 4 == 0
                    and table.numel() // block_floats
                    >= rec.shape[0] // raster.CHUNK,
                    "table must be a contiguous f32 table on the records' "
                    "device with a block of block_floats (a multiple of 4) "
                    "per chunk")
    depth, tri = _tile_outputs(n_tiles, rec.device)
    fn = _build.kernel("trident_visibility_reset",
                       [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] + [ctypes.c_void_p] * 3)
    err = fn(table.data_ptr(), block_floats, bins.pair_chunk.data_ptr(),
             bins.tile_start.data_ptr(), n_tiles, depth.data_ptr(),
             tri.data_ptr(), _stream(rec.device))
    _build.check_launch("trident_visibility_reset", err)
    visibility_reset.launches += 1
    return depth, tri


visibility_reset.launches = 0


def config_fn(bins: raster.Bins, kind: str, ntx: int, n_tiles: int,
              ck_bank: int = 0, plain: bool = False):
    """Config `kind` on `bins` as a no-argument callable returning per-tile
    (depth, tri): the kernel's wrapper, or with plain=True its plain
    PyTorch version. ck_bank > 0 (bins built with it) runs zero/dflt/full
    through the compact-bank kernel."""
    if kind in ("probe", "probe_tiny"):
        table, blk = probe_table(bins, kind == "probe_tiny")
        if plain:
            return lambda: visibility_reset_plain(bins, n_tiles)
        return lambda: visibility_reset(bins, table, blk, n_tiles)
    if kind == "nobranch":
        if plain:
            return lambda: raster.visibility_tiles_plain(bins, ntx, n_tiles,
                                                         dense=True)
        return lambda: visibility_dense(bins, ntx, n_tiles)
    if kind == "dual":
        table2 = dual_table(bins)
        fn = visibility_dual_plain if plain else visibility_dual
        return lambda: fn(bins, table2, ntx, n_tiles)
    b = doctored(bins, kind, ck_bank)
    if ck_bank:
        fn = (raster.visibility_ck_tiles_plain if plain
              else raster.visibility_ck_tiles)
        return lambda: fn(b, ntx, n_tiles, ck_bank)
    fn = raster.visibility_tiles_plain if plain else raster.visibility_tiles
    return lambda: fn(b, ntx, n_tiles)


def run(bins: raster.Bins, ntx: int, n_tiles: int, configs, iters: int = 30,
        ck_bank: int = 0, card_line: str = "cpu") -> dict:
    """One line per config: its kernel's time (CUDA-event median of
    `iters` / device busy; on the CPU one untimed call) and the card.
    Returns {config: (events ms, busy ms)}, or {config: None} on the
    CPU."""
    dev = bins.records.device
    times = {}
    for kind in configs:
        if kind in ("none", ""):
            continue
        if kind not in CONFIGS:
            raise ValueError(f"unknown config {kind!r}: one of {CONFIGS}")
        if ck_bank and kind in ("nobranch", "dual"):
            continue                          # masked-kernel probes only
        fn = config_fn(bins, kind, ntx, n_tiles, ck_bank)
        times[kind] = timed_ms(fn, dev, iters)
        print(f"kind={kind}: {fmt_ms(times[kind])} ({card_line})", flush=True)
    return times


def bins_leg(cs, w: int, h: int, iters: int = 30,
             card_line: str = "cpu") -> None:
    """kbench.py:256-326 (KB_BINS): build_bins, _build_records alone,
    build_bins with _build_records stubbed to zeros of the same shape, one
    torch.sort of an i64 key array the size of the emission pool, then
    build_bins again and with every output consumed."""
    setup, cols = cs.setup, cs.cols.setup
    dev = setup.valid.device
    n_chunks = max(1, -(-setup.valid.shape[0] // raster.CHUNK))
    tpad = n_chunks * raster.CHUNK
    n_tiles = -(-w // raster.TILE) * -(-h // raster.TILE)

    def bb():
        return raster.build_bins(setup, w, h, setup_cols=cols)

    def show(label, fn):
        print(f"{label}: {timed(fn, dev, iters)} "
              f"({card_line})", flush=True)

    show("build_bins", bb)
    show("records_only", lambda: raster._build_records(setup, tpad, cols))
    orig = raster._build_records
    try:
        raster._build_records = (
            lambda s, tp, setup_cols: torch.zeros((tp, raster.REC),
                                                  device=dev))
        show("bins_minus_records", bb)
    finally:
        raster._build_records = orig
    pool = raster.default_pool(n_chunks * raster.NSUB, n_tiles)
    keys = torch.arange(pool, dtype=torch.int64, device=dev).flip(0)
    show(f"raw_sort_{pool}", lambda: torch.sort(keys))
    # build_bins again, last: order effects against real cost
    show("build_bins(again)", bb)

    def consumed():
        b = bb()
        return (b.pair_tile.float().sum() + b.records[0, 0]
                + b.pair_mask.sum().float())

    show("build_bins(full outputs)", consumed)


def sort_leg(dev, iters: int = 30, card_line: str = "cpu") -> None:
    """kbench.py:328-347 (KB_SORT): torch.sort over a ladder of key counts,
    i64 keys (the binner's) in descending order."""
    for n in SORT_LADDER:
        keys = torch.arange(n, dtype=torch.int64, device=dev).flip(0)
        print(f"sort_{n}: {timed(lambda: torch.sort(keys), dev, iters)} "
              f"({card_line})", flush=True)


def records_columns(cc) -> Tensor:
    """The (RR_WIDTH, T) column table, the layout of the JAX package's
    records and of the port's before its (T, RR_WIDTH) rows: the 30
    columns stacked, then padded with zero rows."""
    cols = torch.stack(planes.resolve_parts(cc), dim=0)
    return torch.nn.functional.pad(cols, (0, 0, 0, RR_WIDTH - cols.shape[0]))


def records_leg(r, iters: int = 30, card_line: str = "cpu") -> None:
    """The resolve table's producer, A/B on Renderer r's current frame:
    build_resolve_cols_planar (rows) against records_columns (columns),
    each alone on the frame's corner-stage columns and inside
    frame_geometry with its producer swapped, in the order rows, columns,
    columns, rows (one window; order effects show as the two readings of
    one producer differing)."""
    from trident_tpu_torch.render import renderer

    inp = r.frame_inputs()
    dev = r.device

    def geometry():
        return renderer.frame_geometry(
            inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
            inp["camera"], inp["textures"], inp["corner_t"],
            width=inp["width"], height=inp["height"],
            draw_stride=inp["draw_stride"], real_draws=inp["real_draws"])

    cc = geometry()[0].cols
    producers = {"rows": planes.build_resolve_cols_planar,
                 "columns": records_columns}
    for which in ("rows", "columns", "columns", "rows"):
        make = producers[which]
        renderer.build_resolve_cols_planar = make
        try:
            print(f"records_{which}: {timed(lambda: make(cc), dev, iters)}; "
                  f"geometry_{which}: {timed(geometry, dev, iters)} "
                  f"({card_line})", flush=True)
        finally:
            renderer.build_resolve_cols_planar = (
                planes.build_resolve_cols_planar)


def main(argv=None) -> None:
    from trident_tpu_torch.tools_dev.scenes import build_bench_scene, rotate

    ap = argparse.ArgumentParser(
        description="Visibility-kernel cost decomposition at spheres1080_1m")
    ap.add_argument("--configs", default=DEFAULT_CONFIGS,
                    help=f"comma-separated, of {', '.join(CONFIGS)}")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--grid", type=int, default=36)
    ap.add_argument("--bins", action="store_true",
                    help="the binning-chain decomposition")
    ap.add_argument("--sort", action="store_true", help="the sort ladder")
    ap.add_argument("--records", action="store_true",
                    help="the resolve table's producer, rows against columns")
    ap.add_argument("--kernel", choices=("k1", "ckern"), default="k1")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' (plain versions, untimed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card_line = card() if dev.type == "cuda" else "cpu"
    ck_bank = CK_BANK if args.kernel == "ckern" else 0
    r, reg = build_bench_scene(args.grid, dev)
    rotate(reg, 0)
    cs, _records, bins, w, h = frame_bins(r, ck_bank)
    ntx = -(-w // raster.TILE)
    n_tiles = ntx * -(-h // raster.TILE)
    print(f"device={dev} grid={args.grid} {w}x{h} CHUNK={raster.CHUNK} "
          f"SUB={raster.SUB} kernel={args.kernel}", flush=True)
    report_bins(bins)
    run(bins, ntx, n_tiles, args.configs.split(","), args.iters, ck_bank,
        card_line)
    if args.bins:
        bins_leg(cs, w, h, args.iters, card_line)
    if args.sort:
        sort_leg(dev, args.iters, card_line)
    if args.records:
        records_leg(r, args.iters, card_line)
    print(card_line, flush=True)


if __name__ == "__main__":
    main()
