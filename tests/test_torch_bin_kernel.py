"""Tile binning (ops/raster.py::build_bins): the binning kernels
(csrc/bin_tiles.cu, bin_tiles_kernel) for tensors on the card,
build_bins_plain for tensors on the CPU.

On the CPU: build_bins on CPU tensors is the plain version and counts no
launch; a model of the kernels' passes (each sub-block writing its own pool
slots, keys that carry the sub-block, the sort, run heads numbered by a
cumsum, each head OR-ing its run and writing its pair and its tile_start
entries) gives the plain version's Bins bit for bit, with int32 and with
int64 keys; the wrapper's input checks raise.

On the card (marker `card`; there: python3 -m pytest --noconftest -m card
tests/test_torch_bin_kernel.py) the kernels' Bins against build_bins_plain
on the card, bit for bit in every field (records, pair_tile, pair_chunk,
pair_mask over the whole budget, tile_start, n_real, aux; banks and nhit
under ck_bank): both configurations' 1920×1080 setups (the field of
spheres, and the glTF crowd with its padded bucket), with and without
setup_cols, a band-sliced setup, ck_bank 8, and the small seeded cases
(T not a multiple of 256, a pool overflow, a pair_budget truncation, an
empty scene, int64 keys); one launch per entry point a call; and a
captured frame graph replayed with new transforms, its frame bit-equal to
the plain route's, with 2 launches per entry point for the capture and
none for the replay.

No JAX here."""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from trident_tpu_torch import _build
from trident_tpu_torch.ops import raster, vertex

W, H = 512, 256
ENTRY_POINTS = ("trident_bin_records", "trident_bin_claims",
                "trident_bin_heads", "trident_bin_pairs")
FLOATS = ("records", "banks")
FIELDS = ("records", "pair_tile", "pair_chunk", "pair_mask", "tile_start",
          "n_real", "aux", "banks", "nhit")


def seeded_setup(seed: int, t: int, width: int = W, height: int = H,
                 spread: float = 1.0, size: float = 0.06, near: bool = False,
                 device="cpu"):
    """(TriangleSetup, SetupCols) of t seeded triangles on a width × height
    target: centres within ±spread in NDC, ordered in 16 horizontal strips
    so that a sub-block's triangles lie close together (as a mesh's Morton
    order keeps them), a tenth invalid; `near` puts one vertex of every
    256th triangle behind the eye (a full-screen bbox)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-spread, spread, (t, 2))
    order = np.lexsort((centre[:, 0], np.floor((centre[:, 1] + spread)
                                               * 8 / max(spread, 1e-9))))
    xy = centre[order, None, :] + rng.uniform(-size, size, (t, 3, 2))
    z = rng.uniform(0.1, 0.9, (t, 3))
    w = np.ones((t, 3)) * rng.uniform(0.5, 2.0, (t, 1))
    if near:
        w[::raster.CHUNK, 0] = -0.5
    clip = np.concatenate([xy * w[..., None], (z * w)[..., None],
                           w[..., None]], -1).astype(np.float32)
    valid = torch.as_tensor(rng.uniform(0, 1, t) > 0.1)
    return vertex.triangle_setup_cols(torch.as_tensor(clip, device=device),
                                      None, valid.to(device), width, height)


def case_args(name: str, device="cpu"):
    """(setup, width, height, build_bins keywords) of a small seeded case."""
    if name == "empty":
        setup, cols = seeded_setup(0, 0, device=device)
        return setup, W, H, dict(setup_cols=cols)
    if name == "int64_keys":
        # 2048 × 2048 tiles × 33 chunks: a key space past 31 bits
        setup, cols = seeded_setup(5, 33 * raster.CHUNK - 7, 65536, 65536,
                                   spread=0.02, size=0.0003, device=device)
        return setup, 65536, 65536, dict(setup_cols=cols, pool=150000)
    setup, cols = seeded_setup(1, 1000 if name != "aligned" else 1024,
                               device=device, near=name == "overflow")
    kw = dict(setup_cols=cols)
    if name == "cols_none":
        kw["setup_cols"] = None
    elif name in ("band", "band_nocull"):
        setup = vertex.band_slice_setup(setup, 96, 64,
                                        cull=name == "band")
        return setup, W, 64, kw
    elif name == "ck_bank8":
        kw["ck_bank"] = 8
    elif name == "overflow":
        kw["pool"] = 200
    elif name == "budget":
        n_real = int(raster.build_bins_plain(setup, W, H, cols).n_real)
        kw["pair_budget"] = n_real - 5
    return setup, W, H, kw


CASES = ("random", "aligned", "cols_none", "band", "band_nocull",
         "ck_bank8", "overflow", "budget", "empty", "int64_keys")


def assert_same_bins(got: raster.Bins, want: raster.Bins, what: str) -> None:
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, (what, name)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (
            what, name, a.dtype, b.dtype, tuple(a.shape), tuple(b.shape))
        if name in FLOATS:
            a, b = a.view(torch.int32), b.view(torch.int32)
        same = torch.equal(a, b)
        if not same and a.dim() > 0:
            at = int(torch.nonzero(a.ne(b).flatten())[0])
            raise AssertionError(f"{what}: {name} differs first at "
                                 f"{at} of {a.numel()}")
        assert same, (what, name, a, b)


def kernel_model(setup, width: int, height: int, setup_cols=None,
                 pool=None, pair_budget=None, ck_bank: int = 0,
                 wide=None) -> raster.Bins:
    """The binning kernels' passes on the CPU, as csrc/bin_tiles.cu orders
    them: records and per-sub-block claims in one pass; each sub-block's
    keys written at its own slots [start, min(end, pool)) (no search of the
    pool), the rest the sentinel; a key packs (tile · n_chunks + chunk)
    over the sub-block's 4 bits; one sort; each run's head numbered by a
    cumsum of the heads; the head ORs its run's bits and writes its pair
    and the tile_start entries after the previous pair's tile. `wide`
    forces int64 keys (None: int64 only past 31 bits)."""
    shape = raster.bin_shape(setup.valid.shape[0], width, height, pool,
                             pair_budget, ck_bank)
    t, n_chunks, tpad, n_sub, ntx, nty, n_tiles, pool, budget = shape
    cols = torch.stack(raster._setup_columns(setup, setup_cols), 1)
    valid = torch.zeros(tpad, dtype=torch.bool)
    valid[:t] = setup.valid
    records = torch.zeros((tpad, raster.REC))
    records[:, 2:9:3] = -1.0
    records[:, 12:15] = 1.0
    records[:t][setup.valid, :15] = cols[setup.valid]
    bb = torch.tensor([1 << 20, 1 << 20, 0, 0]).repeat(tpad, 1)
    bb[:t][setup.valid] = setup.bbox[setup.valid].long()
    x0, y0 = (bb[:, c].view(n_sub, raster.SUB).amin(1) for c in (0, 1))
    x1, y1 = (bb[:, c].view(n_sub, raster.SUB).amax(1) for c in (2, 3))
    nonempty = (x1 > x0) & (y1 > y0)
    tx0 = torch.clamp(torch.div(x0, raster.TILE, rounding_mode="floor"),
                      0, ntx - 1)
    ty0 = torch.clamp(torch.div(y0, raster.TILE, rounding_mode="floor"),
                      0, nty - 1)

    def span(hi, lo, n):
        top = torch.div(hi - 1, raster.TILE, rounding_mode="floor")
        return torch.where(nonempty, torch.clamp(top, 0, n - 1) - lo + 1, 0)

    sx, sy = span(x1, tx0, ntx), span(y1, ty0, nty)
    area = sx * sy
    ends = torch.cumsum(area, 0)
    start = ends - area

    sentinel = n_tiles * n_chunks
    if wide is None:
        wide = (sentinel + 1) * raster.NSUB > 2 ** 31 - 1
    keys = torch.full((pool,), sentinel << 4, dtype=torch.int64)
    lim = torch.clamp(torch.minimum(ends, torch.tensor(pool)) - start, min=0)
    s = torch.repeat_interleave(torch.arange(n_sub), lim)
    k = torch.arange(s.numel()) - (torch.cumsum(lim, 0) - lim)[s]
    sxs = torch.clamp(sx[s], min=1)
    tile = (ty0[s] + k // sxs) * ntx + tx0[s] + k % sxs
    keys[start[s] + k] = ((tile * n_chunks + s // raster.NSUB) << 4) \
        | (s % raster.NSUB)
    dropped = ((area > 0) & (ends > pool)).view(n_chunks, raster.NSUB) \
        .any(1).sum()
    if not wide:
        assert keys.numel() == 0 or int(keys.max()) <= 2 ** 31 - 1
        keys = keys.to(torch.int32)

    keys = torch.sort(keys).values
    pk = keys.long() >> 4
    heads = pk != sentinel
    heads[1:] &= pk[1:] != pk[:-1]
    pair_no = torch.cumsum(heads, 0, dtype=torch.int32)
    total = int(pair_no[-1]) if pool else 0
    n_real = min(total, budget)

    real = pk != sentinel
    run = pair_no.long()[real] - 1
    bits = torch.zeros((total, raster.NSUB), dtype=torch.int64)
    bits[run, (keys[real] & 15).long()] = 1
    masks = (bits << torch.arange(raster.NSUB)).sum(1)
    pair_keys = pk[heads][:n_real]
    pair_tile = torch.full((budget,), n_tiles, dtype=torch.int32)
    pair_chunk = torch.zeros(budget, dtype=torch.int32)
    pair_mask = torch.zeros(budget, dtype=torch.int32)
    pair_tile[:n_real] = (pair_keys // n_chunks).int()
    pair_chunk[:n_real] = (pair_keys % n_chunks).int()
    pair_mask[:n_real] = masks[:n_real].int()
    tile_start = torch.zeros(n_tiles + 1, dtype=torch.int32)
    prev = -1
    for p, tl in enumerate(pair_tile[:n_real].tolist()):
        if tl != prev:
            tile_start[prev + 1:tl + 1] = p
            prev = tl
    tile_start[prev + 1:] = n_real
    bins = raster.Bins(
        records=records, pair_tile=pair_tile, pair_chunk=pair_chunk,
        pair_mask=pair_mask, tile_start=tile_start,
        n_real=torch.tensor(n_real),
        aux=torch.tensor([total - n_real, int(dropped)], dtype=torch.int32))
    return raster._with_banks(bins, ck_bank)


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_cpu_build_bins_is_the_plain_version(case):
    setup, w, h, kw = case_args(case)
    before = dict(_build.LAUNCHES)
    bins = raster.build_bins(setup, w, h, **kw)
    assert dict(_build.LAUNCHES) == before
    assert_same_bins(bins, raster.build_bins_plain(setup, w, h, **kw), case)
    aux = bins.aux.tolist()
    if case == "overflow":
        assert aux[0] == 0 and aux[1] >= 1
    elif case == "budget":
        assert aux == [5, 0]
    elif case != "int64_keys":
        assert aux == [0, 0]
    if case == "empty":
        assert int(bins.n_real) == 0 and not bins.tile_start.any()
    elif case != "int64_keys":
        assert int(bins.n_real) > 8


# each case with int32 keys (where its key space fits 31 bits) and int64
MODEL_CASES = [(c, wide) for c in CASES for wide in (False, True)
               if wide or c != "int64_keys"]


@pytest.mark.parametrize("case,wide", MODEL_CASES,
                         ids=[f"{c}-{'int64' if w else 'int32'}"
                              for c, w in MODEL_CASES])
def test_kernel_model_is_the_plain_version(case, wide):
    setup, w, h, kw = case_args(case)
    model = kernel_model(setup, w, h, wide=wide, **kw)
    assert_same_bins(model, raster.build_bins_plain(setup, w, h, **kw), case)


def _refusal(case: str):
    """(setup, setup_cols, BinShape) the wrapper refuses, one field off a
    good case."""
    setup, cols = seeded_setup(2, 300)
    t = setup.valid.shape[0]
    shape = raster.bin_shape(t, W, H)
    e = list(cols.e)
    if case == "valid dtype":
        setup = setup._replace(valid=setup.valid.to(torch.uint8))
    elif case == "valid contiguous":
        setup = setup._replace(valid=setup.valid.repeat(2)[::2])
    elif case == "bbox dtype":
        setup = setup._replace(bbox=setup.bbox.long())
    elif case == "bbox contiguous":
        setup = setup._replace(bbox=setup.bbox.repeat(1, 2)[:, ::2])
    elif case == "bbox shape":
        setup = setup._replace(bbox=setup.bbox[:, :3].contiguous())
    elif case == "column dtype":
        e[4] = e[4].double()
    elif case == "column shape":
        e[4] = e[4][:-1]
    elif case == "mixed devices":
        e[4] = e[4].to("meta")
    elif case == "pool threads":
        shape = raster.bin_shape(t, W, H, pool=2 ** 31)
    elif case == "triangle threads":
        big = 2 ** 31
        setup = setup._replace(
            valid=torch.ones(1, dtype=torch.bool).expand(big),
            bbox=torch.zeros((1, 4), dtype=torch.int32).expand(big, 4))
        shape = raster.bin_shape(big, W, H)
    return setup, cols._replace(e=tuple(e)), shape


REFUSALS = ("valid dtype", "valid contiguous", "bbox dtype",
            "bbox contiguous", "bbox shape", "column dtype", "column shape",
            "mixed devices", "pool threads", "triangle threads", "cpu")


@pytest.mark.parametrize("case", REFUSALS)
def test_wrapper_refuses_what_the_kernels_do_not_take(case):
    setup, cols, shape = _refusal(case)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        raster.bin_tiles_kernel(setup, shape, cols)
    assert dict(_build.LAUNCHES) == before


# -- on the card --------------------------------------------------------------

FW, FH = 1920, 1080


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; where there is one: python3 -m "
                    "pytest --noconftest -m card tests/test_torch_bin_kernel.py")
    _build.load_library()
    return torch.device("cuda", 0)


def binning_inputs(r):
    """(setup, setup_cols) of the build_bins call in Renderer `r`'s eager
    render_frame at 1920×1080."""
    from trident_tpu_torch.render import renderer as rmod

    caught, real = [], raster.build_bins

    def catch(setup, width, height, setup_cols=None, **kw):
        caught.append((setup, setup_cols, width, height))
        return real(setup, width, height, setup_cols=setup_cols, **kw)

    r.editor_camera.set_viewport_size(FW, FH)
    raster.build_bins = catch
    try:
        rmod.render_frame(**r.frame_inputs())
    finally:
        raster.build_bins = real
    torch.cuda.synchronize()
    setup, cols, w, h = caught[0]
    assert (w, h) == (FW, FH)
    return setup, cols


@pytest.fixture(scope="module")
def config_setups(card):
    from trident_tpu_torch.tools_dev import scenes

    with tempfile.TemporaryDirectory() as td:
        crowd = scenes.loaded_crowd(card, scenes.write_tube_gltf(
            Path(td) / "tube.glb"))
        crowd.scene.update(1 / 60)
        field, reg = scenes.build_bench_scene(36, card)
        scenes.rotate(reg, 0)
        out = {"field": binning_inputs(field),
               "crowd": binning_inputs(crowd.renderer)}
    return out


def check_on_card(setup, w, h, what, **kw) -> raster.Bins:
    before = {n: _build.LAUNCHES[n] for n in ENTRY_POINTS}
    bins = raster.build_bins(setup, w, h, **kw)
    assert {n: _build.LAUNCHES[n] - before[n] for n in ENTRY_POINTS} == {
        n: 1 for n in ENTRY_POINTS}
    plain = raster.build_bins_plain(setup, w, h, **kw)
    torch.cuda.synchronize()
    assert_same_bins(bins, plain, what)
    return bins


CONFIG_CASES = ("cols", "cols_none", "band", "ck_bank8")


@pytest.mark.card
@pytest.mark.parametrize("case", CONFIG_CASES)
@pytest.mark.parametrize("name", ("field", "crowd"))
def test_card_bins_on_the_configurations(card, config_setups, name, case):
    setup, cols = config_setups[name]
    w, h, kw = FW, FH, dict(setup_cols=cols)
    if case == "cols_none":
        kw["setup_cols"] = None
    elif case == "band":
        setup, h = vertex.band_slice_setup(setup, 256, 256), 256
    elif case == "ck_bank8":
        kw["ck_bank"] = 8
    bins = check_on_card(setup, w, h, f"{name} {case}", **kw)
    if name == "crowd":
        assert bins.records.shape[0] == 2_097_152    # the padded bucket
    assert bins.aux.tolist() == [0, 0] and int(bins.n_real) > 0


@pytest.mark.card
@pytest.mark.parametrize("case", CASES)
def test_card_bins_on_the_small_cases(card, case):
    setup, w, h, kw = case_args(case, card)
    bins = check_on_card(setup, w, h, case, **kw)
    if case == "overflow":
        assert bins.aux.tolist()[1] >= 1
    elif case == "budget":
        assert bins.aux.tolist() == [5, 0]


@pytest.mark.card
def test_card_captured_frame_graph_replays_with_new_transforms(card,
                                                              monkeypatch):
    from trident_tpu_torch.tools_dev import scenes

    r, reg = scenes.build_bench_scene(36, card)
    scenes.rotate(reg, 0)
    before = {n: _build.LAUNCHES[n] for n in ENTRY_POINTS}
    r.render_viewport()
    torch.cuda.synchronize()
    captured = {n: _build.LAUNCHES[n] - before[n] for n in ENTRY_POINTS}
    assert r.graphs.captures == 1
    scenes.rotate(reg, 3)
    out = r.render_viewport()
    torch.cuda.synchronize()
    out = [t.clone() for t in (out.color, out.depth, out.tri_id, out.aux)]
    replayed = {n: _build.LAUNCHES[n] - before[n] - captured[n]
                for n in ENTRY_POINTS}
    assert r.graphs.captures == 1 and r.graphs.replays >= 1
    assert captured == {n: 2 for n in ENTRY_POINTS}      # warm-up, capture
    assert replayed == {n: 0 for n in ENTRY_POINTS}
    fb = r.frame_bundle()
    monkeypatch.setattr(raster, "build_bins", raster.build_bins_plain)
    plain = fb.frame_fn(torch.from_numpy(fb.f32).to(card),
                        torch.from_numpy(fb.i32).to(card), None, fb.ai)
    torch.cuda.synchronize()
    assert {n: _build.LAUNCHES[n] - before[n] for n in ENTRY_POINTS} \
        == captured
    for a, b in zip(out, (plain.color, plain.depth, plain.tri_id,
                          plain.aux)):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
    assert out[3].tolist() == [0, 0]
