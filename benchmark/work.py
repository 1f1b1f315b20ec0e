"""The least time the card could take for a frame's visibility and
attribute resolve, counted from the frame's own sizes whatever kernel
does the work (a separate visibility and resolve, a fused one, a
compact-bank one), and the peaks it is counted against.

Operations: 22 float32 operations (three edge functions, two mul and two
add each; z and w, three mul and two add each) for each (triangle, pixel
centre) pair inside the triangle's vertex bbox, over the triangles in
view (front-facing, in front of the eye, with a pixel centre in that
bbox). Bytes: each triangle in view's 16-float setup record read once;
each pixel's winner id and depth written once; each distinct winner's
resolve record read once (32 floats, 40 with vertex colours); each
pixel's 16 attribute channels written once.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import raster

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_PAIR = 22
SETUP_RECORD_BYTES = 16 * 4
WINNER_OUT_BYTES = 8                 # id and depth
RESOLVE_ROW_BYTES = 32 * 4
RESOLVE_ROW_BYTES_VCOLOR = 40 * 4
ATTRIBUTE_BYTES = 16 * 4


class RasterWork(NamedTuple):
    in_view: int          # triangles in view
    pairs: int            # (triangle, pixel centre) pairs in their bboxes
    winners: int          # distinct winning triangles
    ops: float
    bytes: float

    def least_ms(self) -> float:
        """The larger of bytes over peak bandwidth and operations over
        peak float32 rate, in ms."""
        return 1e3 * max(self.bytes / HBM_BYTES_PER_S,
                         self.ops / F32_OPS_PER_S)


def bbox_centre_pairs(clip: torch.Tensor, tris: torch.Tensor, width: int,
                      height: int) -> tuple:
    """(triangles in view, pairs): the pixel centres (x + ½, y + ½) inside
    each front-facing triangle's vertex bbox, clipped to the frame, for the
    triangles whose vertices all lie in front of the eye."""
    _e, _z, w, _bbox, valid = raster.setup(clip, tris, width, height)
    c = clip[tris]
    front = valid & (w > 1e-6).all(dim=1)
    sx = (c[..., 0] + c[..., 3]) * (0.5 * width) / c[..., 3]
    sy = (c[..., 1] + c[..., 3]) * (0.5 * height) / c[..., 3]

    def span(lo, hi, size):
        a = torch.ceil(lo - 0.5).clamp(0, size)
        b = (torch.floor(hi - 0.5) + 1.0).clamp(0, size)
        return (b - a).clamp_min(0)

    n = (span(sx.amin(1), sx.amax(1), width)
         * span(sy.amin(1), sy.amax(1), height)).double()
    n = torch.where(front, n, 0.0)
    return int((n > 0).sum()), int(n.sum())


def raster_work(mesh: raster.Mesh, winners: torch.Tensor, width: int,
                height: int) -> RasterWork:
    """The frame's visibility and resolve work: `mesh` as the reference
    placed it, `winners` (H, W) the reference's winner per pixel."""
    in_view, pairs = bbox_centre_pairs(mesh.clip, mesh.tris, width, height)
    n_win = int(torch.unique(winners[winners >= 0]).numel())
    row = (RESOLVE_ROW_BYTES_VCOLOR if mesh.color is not None
           else RESOLVE_ROW_BYTES)
    px = width * height
    nbytes = (in_view * SETUP_RECORD_BYTES + px * WINNER_OUT_BYTES
              + n_win * row + px * ATTRIBUTE_BYTES)
    return RasterWork(in_view, pairs, n_win, float(pairs * OPS_PER_PAIR),
                      float(nbytes))
