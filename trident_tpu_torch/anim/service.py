"""AnimationAssetService: id → baked skeleton/clip cache.

Reference: Animation/AnimationAssetService.{h,cpp} — singleton cache of
Skeleton + AnimationClip[] loaded through the model loader, with
RegisterRuntimeAsset as an injection seam for tests/runtime-generated rigs.

The port's own copy of trident_tpu/anim/service.py (numpy; only the imports
differ): the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from trident_tpu_torch.anim.data import AnimationClip, Skeleton
from trident_tpu_torch.core.log import get_logger

logger = get_logger("anim.service")


class AnimationAssetService:
    _instance: Optional["AnimationAssetService"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._skeletons: Dict[str, Skeleton] = {}
        self._libraries: Dict[str, List[AnimationClip]] = {}

    @classmethod
    def get(cls) -> "AnimationAssetService":
        with cls._lock:
            if cls._instance is None:
                cls._instance = AnimationAssetService()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    # -- injection seam (RegisterRuntimeAsset) --------------------------------
    def register_runtime_asset(self, asset_id: str, skeleton: Skeleton,
                               clips: List[AnimationClip]) -> None:
        self._skeletons[asset_id] = skeleton
        self._libraries[asset_id] = clips

    # -- acquisition -------------------------------------------------------------
    def acquire_skeleton(self, asset_id: str) -> Optional[Skeleton]:
        if asset_id not in self._skeletons:
            self._load(asset_id)
        return self._skeletons.get(asset_id)

    def acquire_animation_library(self, asset_id: str) -> List[AnimationClip]:
        if asset_id not in self._libraries:
            self._load(asset_id)
        return self._libraries.get(asset_id, [])

    def resolve_clip_index(self, asset_id: str, clip_name: str) -> int:
        for i, clip in enumerate(self.acquire_animation_library(asset_id)):
            if clip.name == clip_name:
                return i
        return -1

    def _load(self, asset_id: str) -> None:
        """Load through the model loader (file path as asset id)."""
        try:
            from trident_tpu_torch.assets.model_loader import load_model

            data = load_model(asset_id)
            if data.skeleton is not None:
                self._skeletons[asset_id] = data.skeleton
            self._libraries[asset_id] = data.clips
        except Exception as exc:
            logger.warning("animation asset %r failed to load: %s", asset_id, exc)
            self._libraries.setdefault(asset_id, [])
