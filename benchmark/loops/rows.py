"""A cycle of the traffic's `cycle` frames packed in set-up (the scene
stepped and `Renderer.frame_bundle()` taken for each), uploaded once, then
replayed back to back from device rows through `FrameGraphs.run_rows`, the
harness keeping `in_flight` frames queued: a dataset or video render of a
recorded path. Frame k replays row k % cycle.

A scene whose frames take in state from the frames before them is
refused: the rows are packed before any frame is drawn, so no row carries
a history, and its frames would replay without their warp."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.loops import Loop, takes_given


class RowsLoop(Loop):
    submit = "run_rows"

    def __init__(self, scene, traffic: dict) -> None:
        super().__init__(scene, traffic)
        self.throttle = traffic["in_flight"]

    def setup(self, warmup: int) -> None:
        """Pack the cycle's frames (stepping the scene before each, keeping
        what the scene made at each step), upload their blobs once, warm
        the replays up. A scene that takes given state raises."""
        if takes_given(self.scene):
            raise ValueError(
                f"{type(self.scene).__name__}: its frames take in state from "
                "the frames before them (given), which packed rows cannot "
                "carry: every row is packed before any frame is drawn. Run "
                "it under a draw traffic")
        r = self.scene.renderer
        f32, i32, first = [], [], None
        self.kept = []
        for k in range(self.traffic["cycle"]):
            self.scene.step(k)
            self.kept.append(self.scene.kept(k))
            b = r.frame_bundle()
            if first is None:
                first = b
            elif b.key != first.key:
                raise RuntimeError("the packed frames' graph keys differ")
            f32.append(b.f32)
            i32.append(b.i32)
        self.bundle = first
        dev = r.device
        self.f32 = torch.from_numpy(np.stack(f32)).to(dev)
        self.i32 = torch.from_numpy(np.stack(i32)).to(dev)
        for k in range(warmup):
            self.frame(k)
        self.next = warmup

    @staticmethod
    def ref_step(k: int, traffic: dict) -> int:
        return k % traffic["cycle"]

    def scene_kept(self, k: int) -> dict:
        return self.kept[self.ref_index(k)]

    def frame(self, k: int):
        b, r = self.bundle, self.scene.renderer
        row = self.ref_index(k)
        if r.graphs is None:
            return b.frame_fn(self.f32[row], self.i32[row], b.prev, b.ai)
        return r.graphs.run_rows(b.key, self.f32, self.i32, row, b.prev,
                                 b.ai, b.frame_fn, keep=b.keep)

    def colour(self, out) -> torch.Tensor:
        return out.color.clone()     # the graph's own, until its next replay


LOOP = RowsLoop
