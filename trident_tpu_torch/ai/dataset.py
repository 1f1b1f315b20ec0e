"""Consecutive-frame triplet dataset for interpolation training.

Port of trident_tpu/ai/dataset.py (the reference's semantics,
train_frame_generator.py:52-137): frames sorted by name; sample k yields
input = frame_k ⊕ frame_{k+2} (channel concat) and target = frame_{k+1};
images resized to the net resolution, scaled to [0, 1]. Pure numpy, the
host-side data path feeding device batches, in the JAX layout (H, W, C).

The JAX loader decodes and resizes through PIL. The card's machine has no
PIL, so frames decode with io/image.py (PNG only: any other format raises
ValueError, as load_rgba8 does) and `resize_bilinear_pil` computes PIL's
`Image.BILINEAR` resize: its triangle filter widened by the scale when
shrinking, its 22-bit fixed-point weights and its two uint8 passes
(horizontal, then vertical), so a frame loads to the same bytes.
"""

from __future__ import annotations

import glob
import os
from typing import List, Sequence, Tuple

import numpy as np

from trident_tpu_torch.io.image import read_png

# PIL's fixed point (libImaging/Resample.c): 32 − 8 − 2 fraction bits
_PRECISION_BITS = 22


def list_frames(source: str) -> List[str]:
    """Accepts a directory or a glob pattern; returns sorted image paths."""
    if os.path.isdir(source):
        paths: List[str] = []
        for ext in ("*.png", "*.jpg", "*.jpeg", "*.bmp"):
            paths.extend(glob.glob(os.path.join(source, ext)))
    else:
        paths = glob.glob(source)
    return sorted(paths)


def _pil_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float64 matrix of PIL's 8-bit bilinear weights
    along one axis (Resample.c precompute_coeffs + normalize_coeffs_8bpc):
    a triangle of support 1 × max(scale, 1) around each output centre,
    normalized in double, then rounded to 22-bit integers."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    weights = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        # C's (int) cast truncates toward zero; negatives clamp to 0 anyway
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        xs = np.arange(xmax, dtype=np.float64)
        w = np.maximum(1.0 - np.abs(((xs + xmin) - center + 0.5)
                                    * (1.0 / filterscale)), 0.0)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        weights[xx, xmin:xmin + xmax] = np.trunc(
            0.5 + w * (1 << _PRECISION_BITS))
    return weights


def _pass(img: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """One uint8 pass of PIL's resample along `axis` (0 rows, 1 columns):
    the integer sums are exact in float64 (each below 2^31), then PIL's
    rounding offset and clip8."""
    x = img.astype(np.float64)
    ss = (np.einsum("oi,iwc->owc", weights, x) if axis == 0
          else np.einsum("oi,hic->hoc", weights, x))
    ss = ss.astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    return np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_pil(img: np.ndarray, height: int,
                        width: int) -> np.ndarray:
    """(H, W, C) uint8 → (height, width, C) uint8, as PIL's
    `img.resize((width, height), Image.BILINEAR)` computes it: the
    horizontal pass first when the width changes, then the vertical."""
    if img.shape[1] != width:
        img = _pass(img, _pil_weights(img.shape[1], width), 1)
    if img.shape[0] != height:
        img = _pass(img, _pil_weights(img.shape[0], height), 0)
    return img


def load_frame(path: str, resolution: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] at `resolution` (h, w): the PNG's rgb
    (alpha dropped, as PIL's convert("RGB") drops it) resized as PIL's
    BILINEAR resize does."""
    rgb = read_png(path)[..., :3]
    rgb = resize_bilinear_pil(rgb, resolution[0], resolution[1])
    return rgb.astype(np.float32) / 255.0


class TripletDataset:
    def __init__(self, source: str, resolution: Tuple[int, int] = (256, 256)):
        self.paths = list_frames(source)
        if len(self.paths) < 3:
            raise ValueError(f"need ≥3 frames, found {len(self.paths)} in {source!r}")
        self.resolution = resolution
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self.paths) - 2

    def _frame(self, i: int) -> np.ndarray:
        if i not in self._cache:
            self._cache[i] = load_frame(self.paths[i], self.resolution)
        return self._cache[i]

    def sample(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        a = self._frame(index)
        b = self._frame(index + 2)
        mid = self._frame(index + 1)
        return np.concatenate([a, b], axis=-1), mid

    def batches(self, indices: Sequence[int], batch_size: int):
        """Yield (inputs (B,H,W,6), targets (B,H,W,3)) batches; the last
        partial batch is padded by wrapping (every batch the same shape)."""
        idx = list(indices)
        for start in range(0, len(idx), batch_size):
            chunk = idx[start:start + batch_size]
            while len(chunk) < batch_size:
                chunk.append(idx[(start + len(chunk)) % len(idx)])
            pairs = [self.sample(i) for i in chunk]
            yield (np.stack([p[0] for p in pairs]),
                   np.stack([p[1] for p in pairs]))

    def split(self, val_fraction: float = 0.1, seed: int = 42):
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self))
        n_val = max(1, int(len(self) * val_fraction))
        return order[n_val:].tolist(), order[:n_val].tolist()
