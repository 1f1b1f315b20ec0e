"""The redesigned probe kernels' maps and the shared launch path, on the
CPU (the kernels themselves run only on the card, in chip_smoke.py).

  * a numpy model of csrc/lut_gather.cu's two paths — direct (4 lanes of
    kDirectSteps idx rows a thread, 2-D grid over quad blocks and chunks)
    and staged (an 8-lane slab of one table in XOR-swizzled shared memory,
    a chunk's rows split S ways) — writes every output word exactly once
    with take_along_axis's value, and every staged read falls inside its
    CTA's slab on the word the staging put there, at the three probe shapes
    and a ragged one; the staging stores are free of bank conflicts;
  * the path rule (gather_probe.gather_path) at those shapes, and its
    constants as the kernel source has them;
  * the gather's check raises on L % 4 != 0 and on a misaligned base;
  * the split select's staged span covers every column each form reads,
    at rw 27 and 32, and its shared memory holds the span at any start
    within a 16-byte piece;
  * _build.kernel declares an entry point once and raises on a second
    declaration with other types (on libc, since there is no nvcc here).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from trident_tpu_torch import _build
from trident_tpu_torch.tools_dev import diag_split_kernel as dsk
from trident_tpu_torch.tools_dev import gather_probe as gp

torch.set_num_threads(1)

SRC = _build.CSRC / "lut_gather.cu"
# csrc/lut_gather.cu's launch shapes
DIRECT_THREADS, DIRECT_STEPS = 256, 2
STAGED_THREADS, STAGED_STEPS = 1024, 4
BANKS = 32


def _cases():
    out = dict(gp.cases(gp.make_inputs()))
    out["ragged"] = gp.ragged_case()
    return out


CASES = _cases()


def _slab_at(row, c):
    return row * gp.SLAB + (c ^ ((row >> 2) & (gp.SLAB - 1)))


def _direct_model(tab, idx):
    """(out word index, value) of every store of the direct path, and the
    lane each table read uses, over all CTAs, threads and steps."""
    k_n, rows, lanes = tab.shape
    g_n, n, _ = idx.shape
    quads = n * lanes // 4
    per_cta = DIRECT_THREADS * DIRECT_STEPS
    bx = np.arange(-(-quads // per_cta))
    s = np.arange(DIRECT_STEPS)
    t = np.arange(DIRECT_THREADS)
    q = (bx[:, None, None] * per_cta + s[None, :, None] * DIRECT_THREADS
         + t[None, None, :]).ravel()
    q = q[q < quads]
    lane = (4 * q) % lanes
    flat_idx = idx.reshape(g_n, -1)
    where, what = [], []
    for g in range(g_n):
        for j in range(4):
            word = 4 * q + j
            row = flat_idx[g, word]
            ok = (row >= 0) & (row < rows)
            assert np.array_equal(lane + j, word % lanes)
            for k in range(k_n):
                val = np.where(ok, tab[k, np.clip(row, 0, rows - 1), lane + j],
                               -1)
                where.append((g * k_n + k) * n * lanes + word)
                what.append(val)
    return np.concatenate(where), np.concatenate(what)


def _staged_model(tab, idx):
    """The same for the staged path; asserts inside each CTA that the
    staging fills every slab word once and that every read falls inside the
    slab on the word that holds (row, lane)."""
    k_n, rows, lanes = tab.shape
    g_n, n, _ = idx.shape
    splits = gp.staged_splits(k_n, lanes, g_n, n)
    per = -(-n // splits)
    slots = STAGED_THREADS // 2
    # staging: piece p = (row, half), 4 words each
    p = np.arange(2 * rows)
    st_row = np.repeat(p >> 1, 4)
    st_c = (4 * (p & 1))[:, None] + np.arange(4)[None, :]
    st_pos = _slab_at(st_row, st_c.ravel())
    assert np.array_equal(np.bincount(st_pos, minlength=rows * gp.SLAB),
                          np.ones(rows * gp.SLAB, int))
    t = np.arange(STAGED_THREADS)
    c0, slot = 4 * (t & 1), t >> 1
    where, what = [], []
    for sb in range(lanes // gp.SLAB):
        l0 = sb * gp.SLAB
        for k in range(k_n):
            slab = np.empty(rows * gp.SLAB, np.int64)
            slab[st_pos] = tab[k, st_row, l0 + st_c.ravel()]
            for by in range(g_n * splits):
                g, part = divmod(by, splits)
                r_begin, r_end = part * per, min(n, part * per + per)
                for r0 in range(r_begin, r_end, slots * STAGED_STEPS):
                    r = (r0 + slot[:, None]
                         + slots * np.arange(STAGED_STEPS)[None, :])
                    live = r < r_end
                    rr = r[live]
                    cc = np.broadcast_to(c0[:, None], r.shape)[live]
                    for j in range(4):
                        row = idx[g, rr, l0 + cc + j]
                        ok = (row >= 0) & (row < rows)
                        pos = _slab_at(row[ok], cc[ok] + j)
                        assert ((pos >= 0) & (pos < rows * gp.SLAB)).all()
                        val = np.full(rr.shape, -1, np.int64)
                        val[ok] = slab[pos]
                        assert np.array_equal(val[ok],
                                              tab[k, row[ok], l0 + cc[ok] + j])
                        where.append((g * k_n + k) * n * lanes + rr * lanes
                                     + l0 + cc + j)
                        what.append(val)
    return np.concatenate(where), np.concatenate(what)


@pytest.mark.parametrize("model", [_direct_model, _staged_model],
                         ids=["direct", "staged"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_map_writes_every_word_once(name, model):
    tab, idx = CASES[name]
    g_n, n, lanes = idx.shape
    where, what = model(tab, idx)
    total = g_n * tab.shape[0] * n * lanes
    assert np.array_equal(np.bincount(where, minlength=total),
                          np.ones(total, int))
    out = np.empty(total, np.int64)
    out[where] = what
    assert np.array_equal(out.reshape(g_n, tab.shape[0], n, lanes),
                          gp.numpy_reference(tab, idx))


def test_ragged_case_is_ragged():
    tab, idx = CASES["ragged"]
    n, rows = idx.shape[1], tab.shape[1]
    assert n % (STAGED_THREADS // 2) and n % (DIRECT_THREADS * DIRECT_STEPS
                                              * 4 // idx.shape[2])
    assert idx.shape[0] == 3 and (idx < 0).any() and (idx >= rows).any()
    got = gp.lut_gather(torch.from_numpy(tab), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), gp.numpy_reference(tab, idx))


def test_staging_stores_are_free_of_bank_conflicts():
    """Each warp of the staging loop stores 16 consecutive rows' two
    halves: for each of its four word stores the 32 lanes hit 32 banks."""
    for warp_p0 in range(0, 2 * 6144, 32):
        p = warp_p0 + np.arange(32)
        for j in range(4):
            banks = _slab_at(p >> 1, 4 * (p & 1) + j) % BANKS
            assert len(set(banks.tolist())) == BANKS


def test_staged_reads_spread_each_lane_over_every_bank():
    rows = np.arange(6144)
    for c in range(gp.SLAB):
        assert len(set((_slab_at(rows, c) % BANKS).tolist())) == BANKS


def test_gather_path_rule_at_the_probe_shapes():
    want = {"lut_gather": ("direct", 8), "quad_gather": ("staged", 2),
            "lut_frame": ("staged", 1), "ragged": ("staged", 2)}
    for name, (tab, idx) in CASES.items():
        k, rows, lanes = tab.shape
        g, n, _ = idx.shape
        assert (gp.gather_path(k, rows, lanes, g, n),
                gp.staged_splits(k, lanes, g, n)) == want[name], name
    # no slab fits: 7265 rows of 32 bytes pass 227 KB; L % 8 != 0
    assert gp.gather_path(1, 7265, 128, 64, 7265) == "direct"
    assert gp.gather_path(1, 6144, 132, 8, 6144) == "direct"


def test_rule_constants_match_the_kernel_source():
    src = SRC.read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kSlab")) == gp.SLAB
    assert int(const("kStagedCtas")) == gp.STAGED_CTAS
    assert const("kSlabMaxBytes") == "227 * 1024"
    assert gp.SLAB_MAX_BYTES == 227 * 1024
    assert (int(const("kDirectThreads")), int(const("kDirectSteps")),
            int(const("kStagedThreads")), int(const("kStagedSteps"))) == (
        DIRECT_THREADS, DIRECT_STEPS, STAGED_THREADS, STAGED_STEPS)
    assert const("kSlots") == "kStagedThreads / 2"
    assert gp.STAGED_SLOTS == STAGED_THREADS // 2
    assert "rows <= 4LL * n" in src


def _ints(*shape, offset=0):
    """A contiguous i32 tensor of `shape` whose base lies `offset` words
    past an aligned allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.int32)[offset:].view(*shape)


def test_gather_check_takes_the_probe_shapes():
    for tab, idx in CASES.values():
        gp.check_gather(torch.from_numpy(tab), torch.from_numpy(idx))


@pytest.mark.parametrize("tabs, idx", [
    (_ints(1, 8, 6), _ints(1, 2, 6)),                    # L % 4 != 0
    (_ints(2, 8, 130), _ints(3, 5, 130)),                 # L % 4 != 0
    (_ints(1, 8, 8, offset=1), _ints(1, 2, 8)),           # tables at +4 B
    (_ints(1, 8, 8), _ints(1, 2, 8, offset=2)),           # idx at +8 B
    (_ints(1, 8, 8), _ints(1, 2, 4)),                     # lanes differ
    (_ints(1, 8, 8).transpose(1, 2), _ints(1, 2, 8)),     # not contiguous
])
def test_gather_check_raises(tabs, idx):
    with pytest.raises(ValueError):
        gp.check_gather(tabs, idx)


def test_gather_kernel_path_raises_off_the_card():
    tab, idx = CASES["ragged"]
    with pytest.raises(ValueError):
        gp.lut_gather_path(torch.from_numpy(tab), torch.from_numpy(idx), True)


@pytest.mark.parametrize("form", sorted(dsk.FORMS))
@pytest.mark.parametrize("rw", dsk.RWS)
def test_split_span_covers_every_column_read(form, rw):
    planes, oh = dsk.make_inputs(rw)
    args = dsk.form_inputs(form, planes, oh, "cpu")
    cols = args["planes"][0].shape[1]
    n_win = args["win"].shape[0]
    col = args["win"].long() + args["off"]
    if args["chunk"] is not None:
        col = col + args["chunk"][0].long() * n_win
    lo, hi = dsk.split_span(cols, args["off"], n_win,
                            args["chunk"] is not None)
    assert ((col >= lo) & (col < hi)).all()
    assert (lo, hi) == ((dsk.C, 2 * dsk.C) if form == "K1" else (0, cols))
    assert dsk.split_smem_bytes(lo, hi) <= dsk.SMEM_MAX_BYTES


@pytest.mark.parametrize("span", [0, 1, 7, 8, 9, 255, 256, 1024, 1023])
def test_split_staging_fits_its_pitch(span):
    """stage_rows copies whole 16-byte pieces from the one holding column lo
    to the one holding hi − 1, column c at shift + c − lo: inside the
    plane's pitch for every start within a piece (shift 0..7 elements)."""
    pitch = dsk.plane_pitch(span)
    assert pitch % 8 == 0
    for shift in range(8):
        pieces = -(-(2 * span + 2 * shift) // 16)
        assert 8 * pieces <= pitch
        if span:
            assert shift + span - 1 < pitch


def test_split_span_is_clamped_to_the_row():
    assert dsk.split_span(1024, 3 * 256 + 1, 256, False) == (769, 1024)
    assert dsk.split_span(1024, -300, 256, False) == (0, 0)
    assert dsk.split_span(1024, 2000, 256, False) == (1024, 1024)
    assert dsk.split_span(1024, 5, 256, True) == (0, 1024)
    # a whole row of 8185 columns or more passes the kernel's 48 KB
    assert dsk.split_smem_bytes(0, 8184) <= dsk.SMEM_MAX_BYTES
    assert dsk.split_smem_bytes(0, 8185) > dsk.SMEM_MAX_BYTES


I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _w_range(a, b):
    """csrc/split_select.cu w_range: the int32 w with a <= w <= b."""
    if a > I32_MAX or b < I32_MIN or a > b:
        return 1, 0
    return max(a, I32_MIN), min(b, I32_MAX)


def _i32(x):
    """x wrapped to int32, as the kernel's unsigned arithmetic casts it."""
    return (x + 2**31) % 2**32 - 2**31


def _select_branch(off0, c, n_win, w, lo, hi, cols):
    """Which source the kernel reads column j from ("span", "row" or
    "nan"), checked against the 64-bit column off0 + chunk·n_win + w."""
    base = off0 + c * n_win
    col = base + w
    span = _w_range(lo - base, hi - 1 - base)
    row = _w_range(-base, cols - 1 - base)
    if span[0] <= w <= span[1]:
        assert lo <= col < hi and _i32(w + base - lo) == col - lo
        return "span"
    if row[0] <= w <= row[1]:
        assert 0 <= col < cols and not lo <= col < hi
        assert _i32(w + base) == col
        return "row"
    assert not 0 <= col < cols
    return "nan"


def test_split_select_column_math_is_exact():
    """The kernel picks staged / row / NaN and its indices in 32 bits from
    two closed ranges of w; at int32's edges it agrees with the 64-bit
    column off0 + chunk·n_win + w."""
    rng = np.random.default_rng(0)
    edges = [I32_MIN, I32_MIN + 1, -2**30, -300, -1, 0, 1, 255, 256, 1023,
             1024, 2**30, I32_MAX - 1, I32_MAX]
    assert [_select_branch(*case) for case in (
        (0, 1, 256, 3, 0, 1024, 1024),                      # K2: staged
        (256, 0, 256, 300, 256, 512, 1024),                 # K1 past its span
        (I32_MAX, 1, 256, I32_MIN + 9, 0, 256, 1024),       # column 264
        (0, 4, 256, 0, 0, 1024, 1024))] == ["span", "row", "row", "nan"]
    for _ in range(2000):
        off0, c, w = (int(rng.choice(edges)) if rng.random() < 0.5
                      else int(rng.integers(I32_MIN, I32_MAX))
                      for _ in range(3))
        cols = int(rng.choice([1, 1024, 8184]))
        lo = int(rng.integers(0, cols + 1))
        _select_branch(off0, c, int(rng.choice([1, 3, 256, 65535])), w, lo,
                       int(rng.integers(lo, cols + 1)), cols)


@pytest.fixture
def libc(monkeypatch):
    monkeypatch.setattr(_build, "load_library", lambda: ctypes.CDLL(None))
    monkeypatch.setattr(_build, "_kernels", {})


def test_kernel_declares_each_entry_point_once(libc):
    fn = _build.kernel("abs", [ctypes.c_int])
    assert fn(-3) == 3 and fn.restype is ctypes.c_int
    assert _build.kernel("abs", (ctypes.c_int,)) is fn
    assert list(fn.argtypes) == [ctypes.c_int]


def test_kernel_raises_on_another_declaration(libc):
    _build.kernel("abs", [ctypes.c_int])
    with pytest.raises(ValueError):
        _build.kernel("abs", [ctypes.c_long])
    with pytest.raises(ValueError):
        _build.kernel("abs", [ctypes.c_int, ctypes.c_int])
    assert _build.kernel("abs", [ctypes.c_int])(-5) == 5
