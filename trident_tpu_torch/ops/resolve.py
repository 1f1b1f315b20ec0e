"""Attribute resolve: per-pixel winner ids → the 16 shading channels.

Port of trident_tpu/ops/resolve_pallas.py (the channel layout, the
interpolant math, and the resolve pass as one kernel, csrc/resolve.cu).
On the TPU the winner's record row was selected with one-hot matrix
products over the visibility pass's pair list; on the card it is a direct
load of column tri_id of the (RW, T) record table (ops/planes.py).
"""

from __future__ import annotations

import ctypes

import torch

from trident_tpu_torch import _build
from trident_tpu_torch.ops import planes as P

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


def eval_interpolants(sel: Tensor, pxf: Tensor, pyf: Tensor) -> Tensor:
    """Every shading interpolant from selected record rows `sel` (RW, N) at
    pixel centres (pxf, pyf) (N,) → (CHANNELS, N) f32. Same expressions, in
    the same order, as resolve_pallas._eval_interpolants."""

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

    return torch.stack([
        nx, ny, nz, u, v, mip,
        row(P.RR_CF), row(P.RR_CF + 1), row(P.RR_CF + 2), row(P.RR_CF + 3),
        row(P.RR_MET), row(P.RR_ROUGH), row(P.RR_AMB), row(P.RR_BASE8),
        tsx, tsy,
    ], dim=0)


def resolve_attrs_plain(tri_id: Tensor, records: Tensor) -> Tensor:
    """Plain PyTorch twin of the resolve kernel: (H, W) winner ids and the
    (RW, T) records → (H, W, CHANNELS) f32, zeros where tri_id < 0."""
    h, w = tri_id.shape
    dev = tri_id.device
    flat = tri_id.reshape(-1)
    sel = records[:, flat.clamp_min(0).long()]               # (RW, H·W)
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    pyf = ys[:, None].expand(h, w).reshape(-1)
    pxf = xs[None, :].expand(h, w).reshape(-1)
    attrs = eval_interpolants(sel, pxf, pyf).T                # (H·W, CH)
    attrs = torch.where((flat >= 0)[:, None], attrs, 0.0)
    return attrs.reshape(h, w, CHANNELS)


def resolve_attrs(tri_id: Tensor, records: Tensor) -> Tensor:
    """(H, W, CHANNELS) attribute image: the CUDA kernel for tensors on
    the card, the plain version for tensors on the CPU."""
    if tri_id.device.type == "cpu":
        return resolve_attrs_plain(tri_id, records)
    if tri_id.device.type != "cuda" or records.device != tri_id.device:
        raise ValueError("tri_id and records must be on the same CUDA device")
    if tri_id.dtype != torch.int32 or tri_id.dim() != 2 \
            or not tri_id.is_contiguous():
        raise ValueError("tri_id must be a contiguous (H, W) i32 tensor")
    if records.dtype != torch.float32 or records.dim() != 2 \
            or records.shape[0] < P.RR_EDGE + 1 or not records.is_contiguous():
        raise ValueError("records must be a contiguous (RW, T) f32 table")
    h, w = tri_id.shape
    out = torch.empty((h, w, CHANNELS), dtype=torch.float32,
                      device=tri_id.device)
    fn = _build.kernel("trident_resolve",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p])
    err = fn(tri_id.data_ptr(), records.data_ptr(), records.shape[1], w,
             h * w, out.data_ptr(),
             torch.cuda.current_stream(tri_id.device).cuda_stream)
    _build.check_launch("trident_resolve", err)
    resolve_attrs.launches += 1
    return out


resolve_attrs.launches = 0
