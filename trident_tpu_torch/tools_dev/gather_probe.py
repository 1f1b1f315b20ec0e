"""LUT gather probe on the card: the port's counterpart of the JAX
package's tools_dev/gather_probe.py, which asked whether a Pallas kernel
can gather at all on the TPU. On Hopper a gather is a plain load, and the
port's kernels are built on that premise (the one-hot MXU selects became
indexed loads); this probe measures it: csrc/lut_gather.cu beside the
library call torch.gather and the plain flat-index version.

    python3 -m trident_tpu_torch.tools_dev.gather_probe
    python3 -m trident_tpu_torch.tools_dev.gather_probe --device cpu

The three shapes of the JAX script, with its seeded inputs drawn in its
order (np.random.default_rng(0), gather_probe.py:52-53, 74-75, 103-104):
  lut_gather   one (4096, 128) i32 table, one (4096, 128) idx
  quad_gather  four such tables with one idx (the bilinear quad corners)
  lut_frame    a (6144, 128) table (a 64² mip pyramid with gutters) and
               8 idx chunks of (6144, 128) (4 corners × a 1080p frame)
Each is checked bit for bit against numpy's take_along_axis, then timed.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from trident_tpu_torch import _build, resolve_device
from trident_tpu_torch.tools_dev.timing import card, timed

Tensor = torch.Tensor

R, L = 4096, 128          # table shape of lut_gather and quad_gather
R2, G = 6144, 8           # lut_frame's table rows and idx chunks


def make_inputs(seed: int = 0) -> dict:
    """The JAX script's inputs, drawn in its order."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 1 << 30, (R, L), dtype=np.int32)
    idx = rng.integers(0, R, (R, L), dtype=np.int32)
    tabs = np.stack([rng.integers(0, 1 << 30, (R, L), dtype=np.int32)
                     for _ in range(4)])
    tab2 = rng.integers(0, 1 << 30, (R2, L), dtype=np.int32)
    idx8 = rng.integers(0, R2, (G, R2, L), dtype=np.int32)
    return dict(tab=tab, idx=idx, tabs=tabs, tab2=tab2, idx8=idx8)


def cases(inp: dict) -> dict:
    """name → (tables (K, rows, L), idx chunks (G, n, L)) numpy i32."""
    return {"lut_gather": (inp["tab"][None], inp["idx"][None]),
            "quad_gather": (inp["tabs"], inp["idx"][None]),
            "lut_frame": (inp["tab2"][None], inp["idx8"])}


def ragged_case(seed: int = 1):
    """(tables, idx) numpy i32 of a shape no probe has: 2 tables of 3001
    rows and 136 lanes (17 staged slabs), 3 idx chunks of 2500 rows (not a
    multiple of a CTA's rows), indices from −7 to rows + 6 (some outside
    the table)."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 1 << 30, (2, 3001, 136), dtype=np.int32)
    idx = rng.integers(-7, 3001 + 7, (3, 2500, 136), dtype=np.int32)
    return tab, idx


def lut_gather_plain(tabs: Tensor, idx: Tensor) -> Tensor:
    """Plain twin of the gather kernel, the JAX script's "XLA elementwise
    gather" (gather_probe.py:63-71): the flat index idx·L + lane into each
    table; −1 where idx lies outside [0, rows)."""
    k, rows, lanes = tabs.shape
    ok = (idx >= 0) & (idx < rows)
    lane = torch.arange(lanes, device=idx.device)
    flat = idx.clamp(0, rows - 1).long() * lanes + lane
    got = tabs.reshape(k, -1)[:, flat]                       # (K, G, n, L)
    return torch.where(ok, got, -1).permute(1, 0, 2, 3).contiguous()


# csrc/lut_gather.cu's path rule and its staged grid
SLAB = 8                      # lanes a staged CTA owns (kSlab)
SLAB_MAX_BYTES = 227 * 1024   # shared memory a slab may take
STAGED_SLOTS = 512            # rows a staged CTA serves side by side
STAGED_CTAS = 128             # CTAs the row splits aim for
I32_MAX = 2**31 - 1

_GATHER_ARGS = ((ctypes.c_void_p,) + (ctypes.c_int,) * 3
                + (ctypes.c_void_p,) + (ctypes.c_int,) * 2
                + (ctypes.c_void_p,) * 2)
_GATHER_PATH_ARGS = _GATHER_ARGS[:-1] + (ctypes.c_int, ctypes.c_void_p)


def staged_splits(k: int, lanes: int, g: int, n: int) -> int:
    """Row splits per idx chunk of the staged path: enough CTAs (one per
    slab, table, chunk and split) to reach STAGED_CTAS, at most one per
    STAGED_SLOTS rows (csrc/lut_gather.cu staged_splits)."""
    ctas = lanes // SLAB * k * g
    return max(1, min(-(-STAGED_CTAS // ctas), -(-n // STAGED_SLOTS)))


def staged_fits(k: int, rows: int, lanes: int) -> bool:
    """Whether the staged path can take the tables: whole slabs, and one
    slab of all rows in shared memory."""
    return lanes % SLAB == 0 and k <= 65535 and rows * SLAB * 4 <= \
        SLAB_MAX_BYTES


def gather_path(k: int, rows: int, lanes: int, g: int, n: int) -> str:
    """The kernel's path for K tables (rows, L) and G idx chunks (n, L),
    the rule of csrc/lut_gather.cu's header: "staged" when the slab fits
    and staging moves at most half the direct path's L2 sectors (S·rows ≤
    4·n), else "direct"."""
    if staged_fits(k, rows, lanes) and g > 0 and n > 0 and \
            staged_splits(k, lanes, g, n) * rows <= 4 * n:
        return "staged"
    return "direct"


def check_gather(tabs: Tensor, idx: Tensor) -> None:
    """Raise unless the kernel can take tabs (K, rows, L) and idx (G, n, L):
    contiguous i32 on one device, 16-byte-aligned bases, L % 4 == 0 (one
    int4 a thread), every offset below 2^31 and G ≤ 65535."""
    ts, xs = tabs.shape, idx.shape
    if not (tabs.dtype == idx.dtype == torch.int32 and len(ts) == 3
            and len(xs) == 3 and ts[2] == xs[2] and idx.device == tabs.device
            and tabs.is_contiguous() and idx.is_contiguous()):
        raise ValueError("lut_gather takes contiguous i32 tables (K, rows, L) "
                         "and idx (G, n, L) on one device")
    k, rows, lanes = ts
    g, n, _ = xs
    if (lanes % 4 or tabs.data_ptr() % 16 or idx.data_ptr() % 16
            or rows * lanes > I32_MAX or g * k * n * lanes > I32_MAX
            or g > 65535):
        raise ValueError(f"lut_gather takes L % 4 == 0 (L = {lanes}), "
                         "16-byte-aligned bases and offsets below 2^31")


def _launch(tabs: Tensor, idx: Tensor, staged=None) -> Tensor:
    """One kernel launch: the rule's path, or the path named (staged True
    or False) for an A/B; checks first."""
    if tabs.device.type != "cuda":
        raise ValueError(f"the gather kernel runs on a card, not "
                         f"{tabs.device}")
    check_gather(tabs, idx)
    k, rows, lanes = tabs.shape
    g, n, _ = idx.shape
    out = torch.empty((g, k, n, lanes), dtype=torch.int32, device=tabs.device)
    stream = torch.cuda.current_stream(tabs.device).cuda_stream
    if staged is None:
        name = "trident_lut_gather"
        err = _build.kernel(name, _GATHER_ARGS)(
            tabs.data_ptr(), k, rows, lanes, idx.data_ptr(), g, n,
            out.data_ptr(), stream)
    else:
        name = "trident_lut_gather_path"
        err = _build.kernel(name, _GATHER_PATH_ARGS)(
            tabs.data_ptr(), k, rows, lanes, idx.data_ptr(), g, n,
            out.data_ptr(), int(staged), stream)
    _build.check_launch(name, err)
    return out


def lut_gather(tabs: Tensor, idx: Tensor) -> Tensor:
    """out (G, K, n, L) i32 with out[g, k, r, l] = tabs[k, idx[g, r, l], l]
    for tables tabs (K, rows, L) and idx chunks (G, n, L), −1 where idx lies
    outside [0, rows): the CUDA kernel (its path by gather_path) for
    tensors on the card, the plain version for tensors on the CPU."""
    if tabs.device.type == "cpu":
        return lut_gather_plain(tabs, idx)
    out = _launch(tabs, idx)
    lut_gather.launches += 1
    return out


lut_gather.launches = 0


def lut_gather_path(tabs: Tensor, idx: Tensor, staged: bool) -> Tensor:
    """lut_gather through one named path of the kernel, whatever
    gather_path says: the A/B of the two paths on one shape (card only;
    not counted in lut_gather.launches)."""
    return _launch(tabs, idx, staged)


def library_gather(tabs: Tensor, idx64: Tensor) -> Tensor:
    """The same gather as one torch.gather call: (K, G·n, L) for i64 idx64
    (G, n, L)."""
    k, _rows, lanes = tabs.shape
    return torch.gather(tabs, 1, idx64.reshape(1, -1, lanes).expand(
        k, -1, lanes))


def numpy_reference(tab: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(G, K, n, L): np.take_along_axis per table and chunk, as the JAX
    script checks its kernels; −1 where idx lies outside [0, rows)."""
    rows = tab.shape[1]
    ok = (idx >= 0) & (idx < rows)
    safe = np.clip(idx, 0, rows - 1)
    return np.stack([np.stack([np.where(o, np.take_along_axis(t, i, axis=0),
                                        -1) for t in tab])
                     for i, o in zip(safe, ok)])


def run(device, reps: int = 20, card_line: str = "cpu") -> dict:
    """Check and time the three shapes; raises if the kernel disagrees
    with numpy. Returns name → (tables, idx) on `device`."""
    inp = make_inputs()
    out = {}
    for name, (tab, idx) in cases(inp).items():
        t = torch.from_numpy(tab).to(device)
        i = torch.from_numpy(idx).to(device)
        got = lut_gather(t, i)
        ok = np.array_equal(got.cpu().numpy(), numpy_reference(tab, idx))
        print(f"{name} ({tab.shape[0]} x {tab.shape[1:]} tables, "
              f"{idx.shape[0]} x {idx.shape[1:]} idx) matches "
              f"take_along_axis: {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"{name}: the gather disagrees with numpy")
        i64 = i.long()
        print(f"{name}: kernel {timed(lambda: lut_gather(t, i), device, reps)}"
              f"; torch.gather {timed(lambda: library_gather(t, i64), device, reps)}"
              f"; plain {timed(lambda: lut_gather_plain(t, i), device, reps)}"
              f" ({card_line})", flush=True)
        out[name] = (t, i)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="LUT gather probe")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' (plain version, untimed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card_line = card() if dev.type == "cuda" else "cpu"
    run(dev, args.reps, card_line)
    print(card_line, flush=True)


if __name__ == "__main__":
    main()
