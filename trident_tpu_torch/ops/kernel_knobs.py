"""Kernel knobs: `RenderConfig.kernel`, validated and carried explicitly.

Port of trident_tpu/ops/kernel_knobs.py. The JAX package keeps its knobs
as module globals that kernels bake in at trace time and keys its jit
caches on `trace_key()`, so that two Renderers with different knobs each
render their own frame. Here a Renderer builds one frozen `KernelKnobs`
from `rc.kernel` at construction and passes it down explicitly
(render_frame → _visibility_and_shade → the light pass); no module state
changes, so the same property holds without a cache key.

A dict valid on one side is valid on the other: unknown names raise
KeyError (the JAX `_KNOBS` names), and the JAX package's consistency rules
raise ValueError (raster_pallas.recompute_derived, kernel_knobs
._revalidate). Every other dict renders, as the JAX Renderer renders it:

  * fuse          — visibility + resolve in one kernel
                    (csrc/visibility_resolve.cu)
  * ckern, ck_bank — compact-bank visibility (csrc/visibility_ck.cu);
                    pair_budget sets its pair cap (raster.CK_PAIR_BUDGET,
                    the JAX CKERN budget), so both frames drop alike
  * tiled_shade   — channel-planar shading in the raster's tile layout
                    (ops/deferred_tiled.py), where the JAX gate admits the
                    frame: texel_mxu, texel_max_pix and texel_max_q are
                    its limits (trident_tpu/render/renderer.py:139-144)
  * resolve_prec  — "bf16" runs the resolve kernels' bf16 instances, which
                    round each record word to bf16 as the TPU's one raw
                    bf16 pass of the winner select does; "split" and
                    "fp32" are both exact on the card: the same instances
  * upscale_v2, upscale_dtype, warp_mxu, d2s_mode — the 2× upscaler's V1
                    or V2 path, its conv dtype, the warp's band window
                    (ai/upscaler.py) and the depth-to-space relayout

No-ops on the card, accepted at every valid value: dynhit and acc (TPU
visibility-kernel structures; validated only), zskip and zorder
(bit-identical TPU scheduling), the branches that the JAX tests pin
bit-exact to the default (qgate, recpad, rect, treset, exact_bins,
sort_pad, cover_gate, resolve_skip, resolve_half, resolve_compact,
resolve_tr, shadow_mxu; texel_mxu outside the tiled gate), and the TPU's
layout and capacities that the port's own binning does not have
(tile_h, tile_w, chunk, sub, span0, max_global, planar, texel_slab,
texel_br, texel_bc; pair_budget outside ckern). A capacity under which
the JAX frame drops geometry leaves the port's frame whole: a deliberate
divergence (ROADMAP queue 3).

Every default is the JAX package's env-less default, except
`upscale_dtype`: the port's default is "f32" (f32 convs, held within the
golden gate of the JAX "bf16" default frames); "bf16" is accepted and
runs bf16 convs. The JAX package's TRIDENT_* environment defaults are not
read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

# every knob the JAX package registers (trident_tpu/ops/kernel_knobs.py
# _KNOBS) with its env-less default value
JAX_DEFAULTS: Dict[str, Any] = {
    "tile_h": 32, "tile_w": 32, "chunk": 256, "sub": 16, "span0": 2,
    "sort_pad": False, "exact_bins": False, "cover_gate": False,
    "qgate": False, "ckern": False, "acc": True, "dynhit": True,
    "treset": True, "recpad": False, "rect": False, "ck_bank": 8,
    "zorder": False, "zskip": False, "max_global": 8, "pair_budget": None,
    "fuse": False, "resolve_half": False, "resolve_compact": False,
    "resolve_skip": False, "resolve_prec": "split", "resolve_tr": True,
    "planar": True, "texel_mxu": True, "texel_slab": 512, "texel_br": 8,
    "texel_bc": 256, "texel_max_q": 32768, "texel_max_pix": 4194304,
    "tiled_shade": False, "shadow_mxu": True, "warp_mxu": True,
    "upscale_v2": True, "d2s_mode": "convt", "upscale_dtype": "bf16",
}


@dataclasses.dataclass(frozen=True)
class KernelKnobs:
    """The knobs one Renderer renders with: the fields the port reads, at
    the JAX env-less defaults (upscale_dtype: the port's "f32")."""

    fuse: bool = False
    ckern: bool = False
    ck_bank: int = 8
    pair_budget: Optional[int] = None
    tiled_shade: bool = False
    texel_mxu: bool = True
    texel_max_q: int = JAX_DEFAULTS["texel_max_q"]
    texel_max_pix: int = JAX_DEFAULTS["texel_max_pix"]
    resolve_prec: str = "split"
    upscale_v2: bool = True
    upscale_dtype: str = "f32"
    warp_mxu: bool = True
    d2s_mode: str = "convt"

    @staticmethod
    def from_config(kernel: Optional[Dict[str, Any]]) -> "KernelKnobs":
        """Validate `RenderConfig.kernel` (None = defaults) as the JAX
        package does and return the knob set."""
        kernel = dict(kernel or {})
        unknown = set(kernel) - set(JAX_DEFAULTS)
        if unknown:
            raise KeyError(f"unknown kernel knobs: {sorted(unknown)}; "
                           f"known: {sorted(JAX_DEFAULTS)}")
        _validate({**JAX_DEFAULTS, **kernel})
        fields = {f.name for f in dataclasses.fields(KernelKnobs)}
        return KernelKnobs(**{k: v for k, v in kernel.items() if k in fields})

    @property
    def ck_pair_budget(self) -> Optional[int]:
        """build_bins' pair cap under ckern: pair_budget, or None for the
        default (raster.CK_PAIR_BUDGET)."""
        return self.pair_budget if self.ckern else None


def _validate(k: Dict[str, Any]) -> None:
    """The JAX package's consistency rules on a full knob dict
    (raster_pallas.recompute_derived, then kernel_knobs._revalidate);
    raises ValueError where they do."""
    def require(ok: bool, what: str) -> None:
        if not ok:
            raise ValueError(what)

    ckern, qgate, dynhit, rect = k["ckern"], k["qgate"], k["dynhit"], k["rect"]
    sub, chunk, tile_h, tile_w = k["sub"], k["chunk"], k["tile_h"], k["tile_w"]
    require(not (ckern and qgate), "ckern and qgate are exclusive")
    require(not (dynhit and (ckern or qgate or rect)),
            "dynhit is exclusive with ckern/qgate/rect")
    require(not dynhit or k["acc"], "dynhit requires acc")
    require(sub >= 1, f"sub={sub} must be >= 1")
    require(chunk >= sub and chunk % sub == 0,
            f"chunk={chunk} must be a positive multiple of sub={sub}")
    nsub = chunk // sub
    require(not dynhit or sub % 8 == 0, f"dynhit needs sub={sub} % 8 == 0")
    require(tile_h >= 1 and 128 % tile_h == 0, f"tile_h={tile_h} must "
            "divide 128")
    require(tile_w >= 1 and 256 % tile_w == 0, f"tile_w={tile_w} must "
            "divide 256")
    require(k["span0"] >= 1, f"span0={k['span0']} must be >= 1")
    nq = 4 if qgate else 1
    require(not qgate or (tile_h * tile_w) % (nq * 128) == 0,
            "qgate needs lane-aligned tile quarters")
    require(not qgate or tile_h % nq == 0,
            f"tile_h={tile_h} must split into {nq} quarters for qgate")
    if ckern:
        mask_words = 1
    elif dynhit:
        dyn_bits = max(1, (nsub - 1).bit_length())
        mask_words = 1 + -(-nsub // (30 // dyn_bits))
    else:
        mask_words = -(-(nsub * nq) // 30)
    require(k["max_global"] >= 1, f"max_global={k['max_global']} must be "
            ">= 1")
    require(mask_words <= (4 if dynhit else 3),
            f"chunk={chunk}/sub={sub} needs {mask_words} hit-mask words")
    if ckern:
        bank = k["ck_bank"]
        require(bank >= 1, f"ck_bank={bank} must be >= 1")
        require(-(-nsub // bank) <= 8, f"ck_bank={bank}: too many banks")
        require(bank * sub <= 2048, f"ck_bank={bank}×sub={sub} rows per "
                "bank are too many")
    require(k["resolve_prec"] in ("fp32", "split", "bf16"),
            f"resolve_prec={k['resolve_prec']!r}: expected fp32 | split | "
            "bf16")
    require(not k["resolve_half"] or chunk % 2 == 0,
            "resolve_half=True requires an even chunk")
    require(not k["fuse"] or (k["acc"] and not ckern and not rect
                              and k["resolve_tr"]),
            "fuse=True requires acc=True, ckern=False, rect=False, "
            "resolve_tr=True")
    require(k["d2s_mode"] in ("convt", "pad", "xla"),
            f"d2s_mode={k['d2s_mode']!r}: expected convt | pad | xla")
    require(k["upscale_dtype"] in ("bf16", "f32"),
            f"upscale_dtype={k['upscale_dtype']!r}: expected bf16 | f32")
