"""A closed loop of the scene's step and `Renderer.draw_frame()`, as an
editor or game loop runs it; the Renderer keeps the traffic's `in_flight`
frames outstanding on the card and waits for the oldest past that."""

from __future__ import annotations

import torch

from benchmark.loops import Loop


class DrawLoop(Loop):
    def __init__(self, scene, traffic: dict) -> None:
        super().__init__(scene, traffic)
        scene.renderer.max_inflight = traffic["in_flight"]

    def setup(self, warmup: int) -> None:
        """Warm-up frames: the frame graph's capture and the caches."""
        for k in range(warmup):
            self.last = self.frame(k)
        self.next = warmup

    def frame(self, k: int):
        self.scene.step(k)
        return self.scene.renderer.draw_frame()

    def scene_kept(self, k: int) -> dict:
        return self.scene.kept(k)

    def colour(self, out) -> torch.Tensor:
        """The frame's RGBA8 image, kept past later frames."""
        return out.color             # draw_frame hands out clones


LOOP = DrawLoop
