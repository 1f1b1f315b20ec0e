"""Split-bf16 select probe on the card: the port's counterpart of the JAX
package's tools_dev/diag_split_kernel.py (TPU run r3hw9 found its one-hot
select of three stacked bf16 planes losing the mid and lo planes).

    python3 -m trident_tpu_torch.tools_dev.diag_split_kernel
    python3 -m trident_tpu_torch.tools_dev.diag_split_kernel --device cpu

An f32 record table (rw, 1024) splits into hi + mid + lo bf16 planes, the
precision split the JAX resolve pass relies on (resolve_pallas.py::
_prep_records); each form selects chunk 1's 256 lanes through a one-hot
permutation `win` and reassembles (hi + mid) + lo. On Hopper a one-hot
select is a direct load (csrc/split_select.cu), so every error should be 0:

  K1  stacked (3, rw, 1024) planes, a static chunk offset: parts and sum
  K2  stacked planes, the chunk offset from a scalar on the device
  K3  three separate plane tensors, the chunk from the scalar: the sum only

at rw 27 (not a multiple of 8) and 32, printing the JAX script's report
lines (maxerr, share of values off) against host_parts, the numpy product
with the one-hot matrix.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from trident_tpu_torch import _build, resolve_device
from trident_tpu_torch.tools_dev.timing import card

Tensor = torch.Tensor

C = 256         # lanes per chunk
NC = 4          # chunks
RWS = (27, 32)
FORMS = {"K1": "whole-array, static chunk slice",
         "K2": "dynamic chunk offset from a device scalar",
         "K3": "three separate plane inputs"}


def make_inputs(rw: int, seed: int = 0):
    """(planes (3, rw, NC·C) bf16, one-hot (C, C) f32 numpy): the JAX
    script's make_inputs with torch.bfloat16 in place of ml_dtypes (both
    round f32 → bf16 to nearest even)."""
    rng = np.random.default_rng(seed)
    rec = torch.from_numpy(rng.standard_normal((rw, NC * C)).astype(np.float32))
    hi = rec.to(torch.bfloat16).float()
    r1 = rec - hi
    mid = r1.to(torch.bfloat16).float()
    lo = (r1 - mid).to(torch.bfloat16)
    planes = torch.stack([hi.to(torch.bfloat16), mid.to(torch.bfloat16), lo])
    win = rng.integers(0, C, (C,))
    oh = np.zeros((C, C), np.float32)
    oh[win, np.arange(C)] = 1.0
    return planes, oh


def host_parts(planes: Tensor, oh: np.ndarray):
    """The three planes' chunk-1 lanes times the one-hot matrix, in numpy
    f32 (diag_split_kernel.py:36-39)."""
    sel = planes[:, :, C:2 * C].float().numpy()
    return [sel[k] @ oh for k in range(3)]


def split_select_plain(planes, win: Tensor, off: int = 0,
                       chunk: Tensor = None, parts: bool = True):
    """Plain twin of the select kernel: indexing and the (a + b) + c sum;
    NaN where the column lies outside the row."""
    cols = planes[0].shape[1]
    col = win.long() + off
    if chunk is not None:
        col = col + chunk[0].long() * win.shape[0]
    ok = (col >= 0) & (col < cols)
    ps = [torch.where(ok, p[:, col.clamp(0, cols - 1)].float(), float("nan"))
          for p in planes]
    return (torch.stack(ps) if parts else None), (ps[0] + ps[1]) + ps[2]


# csrc/split_select.cu's shared-memory span
SMEM_MAX_BYTES = 48 * 1024
_SELECT_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2
                + (ctypes.c_longlong, ctypes.c_int) + (ctypes.c_void_p,) * 2
                + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 3)


def plane_pitch(span: int) -> int:
    """Shared-memory bf16 elements per plane for a span of `span` columns:
    whole 16-byte pieces, one more for a start inside a piece."""
    return 8 * ((span + 7) // 8 + 1)


def split_span(cols: int, off: int, n_win: int, dynamic: bool):
    """The columns [lo, hi) the kernel stages: the whole row when the
    chunk comes from the device, else the static chunk's n_win columns
    from `off`, both inside [0, cols)."""
    if dynamic:
        return 0, cols
    return min(max(off, 0), cols), min(max(off + n_win, 0), cols)


def split_smem_bytes(lo: int, hi: int) -> int:
    """The kernel's shared memory for span [lo, hi): three planes."""
    return 3 * 2 * plane_pitch(hi - lo)


def check_select(planes, win: Tensor, chunk):
    """Raise unless the kernel can take the planes, win and chunk: three
    (rows, cols) bf16 planes with one row stride and unit lane stride (a
    stacked (3, rows, cols) tensor or three tensors), a contiguous (n,) i32
    win and an optional one-element i32 chunk, all on one device; else
    return (rows, cols, row stride, the three planes' data pointers)."""
    if isinstance(planes, Tensor):
        ok = planes.dim() == 3 and planes.shape[0] == 3
        if ok:
            _n, rows, cols = planes.shape
            step, stride, unit = planes.stride()
            base = planes.data_ptr()
            ptrs = (base, base + 2 * step, base + 4 * step)
        tensors = (planes,)
    else:
        p0, p1, p2 = planes
        stride, unit = p0.stride()
        rows, cols = p0.shape
        ok = (p0.dim() == 2 and p1.shape == p2.shape == p0.shape
              and p1.stride() == p2.stride() == (stride, unit))
        ptrs = (p0.data_ptr(), p1.data_ptr(), p2.data_ptr())
        tensors = (p0, p1, p2)
    dev = tensors[0].device
    if not (ok and unit == 1 and stride >= cols
            and all(t.dtype == torch.bfloat16 and t.device == dev
                    for t in tensors)):
        raise ValueError("planes must be three (rows, cols) bf16 planes "
                         "with one row stride and unit lane stride on one "
                         "device")
    if not (win.dtype == torch.int32 and win.dim() == 1
            and win.is_contiguous() and win.device == dev
            and (chunk is None or (chunk.dtype == torch.int32
                                   and chunk.numel() == 1
                                   and chunk.device == dev))):
        raise ValueError("win must be a contiguous (n,) i32 tensor and chunk "
                         "one i32, on the planes' device")
    return rows, cols, stride, ptrs


def split_select(planes, win: Tensor, off: int = 0, chunk: Tensor = None,
                 parts: bool = True):
    """(parts (3, rows, n_win) f32 or None, sum (rows, n_win) f32) with
    part_k[r, j] = float(planes[k][r, off + chunk·n_win + win[j]]) and sum
    = (part_0 + part_1) + part_2, NaN where the column lies outside the
    row. `planes` is three (rows, cols) bf16 planes (a stacked (3, rows,
    cols) tensor or three tensors); `chunk` an optional one-element i32
    tensor on the planes' device. The CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    dev = planes.device if isinstance(planes, Tensor) else planes[0].device
    if dev.type == "cpu":
        return split_select_plain(planes, win, off, chunk, parts)
    rows, cols, stride, ptrs = check_select(planes, win, chunk)
    n_win = win.shape[0]
    lo, hi = split_span(cols, off, n_win, chunk is not None)
    if split_smem_bytes(lo, hi) > SMEM_MAX_BYTES:
        raise ValueError(f"split_select stages columns [{lo}, {hi}) of each "
                         f"row: {split_smem_bytes(lo, hi)} bytes of shared "
                         f"memory, more than {SMEM_MAX_BYTES}")
    out_parts = (torch.empty((3, rows, n_win), dtype=torch.float32,
                             device=dev) if parts else None)
    out_sum = torch.empty((rows, n_win), dtype=torch.float32, device=dev)
    err = _build.kernel("trident_split_select", _SELECT_ARGS)(
        *ptrs, rows, cols, stride, off,
        chunk.data_ptr() if chunk is not None else None,
        win.data_ptr(), n_win, lo, hi,
        out_parts.data_ptr() if parts else None, out_sum.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("trident_split_select", err)
    split_select.launches += 1
    return out_parts, out_sum


split_select.launches = 0


def form_inputs(form: str, planes: Tensor, oh: np.ndarray, device):
    """split_select's arguments for form K1, K2 or K3 on `device`: the
    planes (stacked, or three separate tensors for K3), win, the static
    offset, the chunk scalar and whether parts are written."""
    planes = planes.to(device)
    win = torch.from_numpy(oh.argmax(0).astype(np.int32)).to(device)
    if form == "K1":
        return dict(planes=planes, win=win, off=C, chunk=None, parts=True)
    chunk = torch.ones(1, dtype=torch.int32, device=device)
    if form == "K2":
        return dict(planes=planes, win=win, off=0, chunk=chunk, parts=True)
    return dict(planes=[p.clone() for p in planes], win=win, off=0,
                chunk=chunk, parts=False)


def report(tag: str, got: Tensor, want: np.ndarray) -> float:
    """diag_split_kernel.py:58-61's line; returns the max error (inf if
    any value is NaN)."""
    d = np.abs(got.cpu().numpy().astype(np.float32) - want)
    print(f"  {tag}: maxerr={d.max():.3e} neq={(d > 0).mean():.4f}",
          flush=True)
    return float(np.nan_to_num(d.max(), nan=np.inf))


def run(device) -> float:
    """Every form at rw 27 and 32, in the JAX script's order; returns the
    largest error against host_parts."""
    worst = 0.0
    for rw in RWS:
        planes, oh = make_inputs(rw)
        want = host_parts(planes, oh)
        for form, what in FORMS.items():
            parts, total = split_select(**form_inputs(form, planes, oh,
                                                      device))
            print(f"{form} rw={rw} ({what}):", flush=True)
            if parts is not None:
                for k in range(3):
                    worst = max(worst, report(f"part{k}", parts[k], want[k]))
            worst = max(worst, report("sum", total,
                                      want[0] + want[1] + want[2]))
    print("DONE", flush=True)
    return worst


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="split-bf16 select probe")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' (the plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}" + (f" ({card()})" if dev.type == "cuda" else ""),
          flush=True)
    run(dev)


if __name__ == "__main__":
    main()
