"""Reference rasterizer: the O(T × pixels) visibility pass.

Port of trident_tpu/ops/raster_ref.py: it evaluates every triangle against
every pixel, a chunk of triangles at a time, and keeps the nearest-depth
winner (LESS_OR_EQUAL, later triangle wins ties). Depth is the rational
z/w with the kernel's (e0·z0 + e1·z1) + e2·z2 association; the oracle
divides where the kernels multiply by an IEEE reciprocal, so depths may
differ by one rounding step.

It is the Renderer's `use_pallas=False` route (render/renderer.py) and the
oracle of the tests. The JAX package calls it the correctness oracle for
goldens and small scenes: each chunk holds (chunk, 3, H, W) f32 edge
values, 12.6 MB at 128² and chunk 64. It reads nothing back to the host
and makes no tensor from host data, so a CUDA graph can capture it.
"""

from __future__ import annotations

import torch

from trident_tpu_torch.ops.vertex import TriangleSetup
from trident_tpu_torch.render.types import GBuffer


def visibility_ref(setup: TriangleSetup, width: int, height: int,
                   chunk: int = 64, depth_clear: float = 1.0) -> GBuffer:
    """Per-pixel winner id (−1 background) and depth of every valid
    triangle, with aux a (2,) i32 zero on the setup's device (nothing is
    binned, so nothing can be dropped)."""
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
    return GBuffer(tri_id=best_tri, depth=best_depth,
                   aux=torch.zeros(2, dtype=torch.int32, device=dev))
