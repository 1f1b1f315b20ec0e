"""Unified typed configuration.

The reference engine scatters configuration across env vars
(`TRIDENT_AI_MODEL`, `TRIDENT_DATASET_CAPTURE_*`), an INI file
(`TridentOnnxRuntime.ini`), CMake options, and editor UI state (reference:
`Trident/src/Renderer/Renderer.cpp:561-576`, `AI/OnnxRuntimeContext.cpp:46-127`).
Here everything lives in one typed, serializable config tree; env vars are
honoured as overrides at construction time so existing workflows keep working.

The port's own copy of trident_tpu/core/config.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class RenderConfig:
    """Raster pipeline capacities. The capacity constants mirror the
    reference's de-facto spec (Pipeline.h:18, UniformBuffer.h:7,
    Renderer.h:291, Vertex.h:11)."""

    width: int = 1920
    height: int = 1080
    max_textures: int = 256          # sampler-array slots; slot 0 = white
    max_point_lights: int = 8
    max_bones: int = 128             # per skeleton
    bone_influences: int = 4         # per vertex
    texture_size: int = 1024         # texture size CAP (pow2): larger
                                     # images downscale to fit; every slot
                                     # stores only its own pow2 pyramid
    clear_color: Tuple[float, float, float, float] = (0.05, 0.05, 0.08, 1.0)
    use_pallas: Optional[bool] = None  # None = auto (TPU yes, CPU interpret)
    sampling: str = "bilinear"       # texture quality: nearest|bilinear|trilinear
    plane_f16: bool = True           # f16 attribute-plane tables (32B gather
                                     # rows, ~36% faster deferred at 1M tris;
                                     # 66dB PSNR vs f32 on hardware — see
                                     # ops/planes.py). False = exact f32.
                                     # Only used when forward_shading is off.
    forward_shading: bool = True     # resolve attributes in-kernel (one-hot
                                     # MXU select, ops/resolve_pallas.py)
                                     # instead of per-pixel plane gathers;
                                     # applies to the pallas raster only
    shadows: bool = False            # directional shadow-map pass
    shadow_map_size: int = 1024
    shadow_pcf: bool = False         # 2x2 bilinear PCF soft edges (4 gathers/px)
    supersample: int = 1             # per-axis SSAA factor (MSAA analogue)
    bands: int = 1                   # >1: split the frame into row bands over
                                     # the device mesh (parallel.framebuffer)
    raster_drop_checks: bool = True  # warn on readback when the binned
                                     # raster dropped geometry (capacity)
    bloom: bool = False
    bloom_threshold: float = 1.0     # linear HDR threshold
    bloom_strength: float = 0.6
    ai_upscale: bool = False         # render at half res + neural 2x
                                     # reconstruction (ai/upscaler.py);
                                     # needs a trained checkpoint
    kernel: Optional[dict] = None    # kernel-knob overrides by name (see
                                     # ops/kernel_knobs.py: chunk, tile_h,
                                     # qgate, zskip, resolve_prec, ...).
                                     # Applied at Renderer construction;
                                     # env TRIDENT_* vars stay the defaults


@dataclass
class AiConfig:
    """Frame-interpolation net settings (reference: Renderer.cpp:839-1109,
    Scripts/train_frame_generator.py)."""

    model_path: Optional[str] = None      # orbax checkpoint dir
    enabled: bool = False
    blend: float = 0.5                    # AiBlendConfig.x
    net_resolution: Tuple[int, int] = (256, 256)
    cadence_ms: float = 66.0              # inference throttle (≈15 Hz)
    base_channels: int = 32
    upscaler_path: Optional[str] = None   # 2x super-resolution weights, an
                                          # .npz export (default the port's
                                          # assets/upscaler_2x.npz)


@dataclass
class CaptureConfig:
    """Dataset capture + perf capture (reference: FrameDatasetRecorder.h,
    Renderer.cpp:6345-6391)."""

    dataset_enabled: bool = False
    dataset_dir: str = "DatasetCaptures"
    dataset_interval_s: float = 0.5
    perf_dir: str = "PerformanceCaptures"


@dataclass
class EngineConfig:
    render: RenderConfig = field(default_factory=RenderConfig)
    ai: AiConfig = field(default_factory=AiConfig)
    capture: CaptureConfig = field(default_factory=CaptureConfig)
    assets_root: str = "Assets"
    log_file: Optional[str] = "trident_tpu.log"

    @staticmethod
    def from_env(base: Optional["EngineConfig"] = None) -> "EngineConfig":
        """Apply the reference's env-var overrides on top of `base`."""
        cfg = base or EngineConfig()
        model = os.environ.get("TRIDENT_AI_MODEL")
        if model:
            cfg.ai.model_path = model
            cfg.ai.enabled = True
        if os.environ.get("TRIDENT_DATASET_CAPTURE_ENABLE", "") not in ("", "0", "false"):
            cfg.capture.dataset_enabled = True
        cap_dir = os.environ.get("TRIDENT_DATASET_CAPTURE_DIR")
        if cap_dir:
            cfg.capture.dataset_dir = cap_dir
        return cfg

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "EngineConfig":
        raw = json.loads(text)
        return EngineConfig(
            render=RenderConfig(**raw.get("render", {})),
            ai=AiConfig(**{k: tuple(v) if k == "net_resolution" else v
                           for k, v in raw.get("ai", {}).items()}),
            capture=CaptureConfig(**raw.get("capture", {})),
            assets_root=raw.get("assets_root", "Assets"),
            log_file=raw.get("log_file"),
        )
