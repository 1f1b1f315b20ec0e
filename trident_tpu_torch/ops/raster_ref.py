"""Reference rasterizer: the O(T × pixels) visibility oracle.

Port of trident_tpu/ops/raster_ref.py, a CPU test oracle only: it
evaluates every triangle against every pixel and keeps the nearest-depth
winner (LESS_OR_EQUAL, later triangle wins ties). Depth is the rational
z/w with the kernel's (e0·z0 + e1·z1) + e2·z2 association; the oracle
divides where the kernels multiply by an IEEE reciprocal, so depths may
differ by one rounding step.
"""

from __future__ import annotations

import torch

from trident_tpu_torch.ops.vertex import TriangleSetup
from trident_tpu_torch.render.types import GBuffer


def visibility_ref(setup: TriangleSetup, width: int, height: int,
                   chunk: int = 64, depth_clear: float = 1.0) -> GBuffer:
    dev = setup.edge.device
    t = setup.edge.shape[0]
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")            # (H,W)
    best_depth = torch.full((height, width), depth_clear, dtype=torch.float32,
                            device=dev)
    best_tri = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    for base in range(0, t, chunk):
        edge = setup.edge[base:base + chunk]
        z = setup.z[base:base + chunk, :, None, None]
        w = setup.w[base:base + chunk, :, None, None]
        e = (edge[:, :, 0, None, None] * px + edge[:, :, 1, None, None] * py
             + edge[:, :, 2, None, None])                     # (C,3,H,W)
        cover = (e >= 0.0).all(dim=1)
        zi = (e[:, 0] * z[:, 0] + e[:, 1] * z[:, 1]) + e[:, 2] * z[:, 2]
        wi = (e[:, 0] * w[:, 0] + e[:, 1] * w[:, 1]) + e[:, 2] * w[:, 2]
        depth = zi / torch.where(wi.abs() < 1e-12, 1e-12, wi)
        # the kernels' cross-multiplied depth-range test, not 0 ≤ z/w ≤ 1
        cover &= (wi > 1e-12) & (zi >= 0.0) & (zi <= wi)
        cover &= setup.valid[base:base + chunk, None, None]
        depth = torch.where(cover, depth, torch.inf)
        c = depth.shape[0]
        # later triangle wins ties: the LAST argmin
        idx = c - 1 - torch.argmin(depth.flip(0), dim=0)
        chunk_depth = torch.gather(depth, 0, idx[None])[0]
        better = chunk_depth <= best_depth
        best_depth = torch.where(better, chunk_depth, best_depth)
        best_tri = torch.where(better, (idx + base).to(torch.int32), best_tri)
    best_depth = torch.where(best_tri >= 0, best_depth, depth_clear)
    return GBuffer(tri_id=best_tri, depth=best_depth)
