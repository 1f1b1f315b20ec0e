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
._revalidate). What the port then runs:

  * fuse         — visibility + resolve in one kernel (csrc/visibility_resolve.cu)
  * ckern, ck_bank — compact-bank visibility (csrc/visibility_ck.cu)
  * tiled_shade  — channel-planar shading in the raster's tile layout
                   (ops/deferred_tiled.py)
  * dynhit, acc  — validated only: they select TPU kernel structures, and
                   the port's visibility kernel serves every setting
  * zskip, zorder — accepted as no-ops: bit-identical TPU scheduling (the
                   JAX Renderer itself turns them on for shadowed scenes)

Every other knob runs only at the value the port implements — the JAX
package's default, except `upscale_dtype`, whose port value is "f32" (the
port's upscaler convs are f32; the JAX default "bf16" is not ported). Any
other value raises NotImplementedError naming the knob. The JAX package's
TRIDENT_* environment defaults are not read.
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

# knobs the port runs at any valid value
PORTED = ("fuse", "ckern", "ck_bank", "tiled_shade", "dynhit", "acc",
          "zskip", "zorder")

# the value the port implements, for every other knob
PORT_VALUES: Dict[str, Any] = {**JAX_DEFAULTS, "upscale_dtype": "f32"}

# the tiled-shade gate's limits (texel_max_pix, texel_max_q): TPU VMEM
# sizes the JAX package routes on, kept so that both packages route alike
TILED_MAX_PIX = JAX_DEFAULTS["texel_max_pix"]
TILED_MAX_TABLE = JAX_DEFAULTS["texel_max_q"]


@dataclasses.dataclass(frozen=True)
class KernelKnobs:
    """The knob set one Renderer renders with (the JAX env-less
    defaults)."""

    fuse: bool = False
    ckern: bool = False
    ck_bank: int = 8
    tiled_shade: bool = False
    dynhit: bool = True
    acc: bool = True

    @staticmethod
    def from_config(kernel: Optional[Dict[str, Any]]) -> "KernelKnobs":
        """Validate `RenderConfig.kernel` (None = defaults) as the JAX
        package does, refuse what the port does not run, and return the
        knob set."""
        kernel = dict(kernel or {})
        unknown = set(kernel) - set(JAX_DEFAULTS)
        if unknown:
            raise KeyError(f"unknown kernel knobs: {sorted(unknown)}; "
                           f"known: {sorted(JAX_DEFAULTS)}")
        _validate({**JAX_DEFAULTS, **kernel})
        unported = sorted(name for name, value in kernel.items()
                          if name not in PORTED
                          and value != PORT_VALUES[name])
        if unported:
            raise NotImplementedError(
                "kernel knobs not ported to trident_tpu_torch: "
                + ", ".join(f"{n}={kernel[n]!r}" for n in unported))
        fields = {f.name for f in dataclasses.fields(KernelKnobs)}
        return KernelKnobs(**{k: v for k, v in kernel.items() if k in fields})


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
