"""Every kernel knob the JAX package accepts renders in the port: the
resolve and fetch knobs, each held against the JAX Renderer's frame under
the same knob on test_torch_knob_frames.py's scene and gates (its no-FMA
child), and the bf16 winner select (resolve_prec="bf16").

  * The resolve branches that the JAX tests pin bit-exact (resolve_skip,
    resolve_half, resolve_compact, resolve_prec="fp32", resolve_tr=False;
    tests/test_resolve_pallas.py:97, 110, 133, 189, 159) and the fetch
    ones (texel_mxu=False, the texel kernel's blocking, shadow_mxu=False
    on the shadowed scene; tests/test_texel_mxu.py:33,
    tests/test_shadow_mxu.py:42) are no-ops on the card: the port's frame
    is its default frame.
  * resolve_prec="bf16": on the TPU the winner select contracts the f32
    records in one raw bf16 pass, so every record word a pixel reads is
    rounded to bf16. The JAX CPU interpreter computes plain f32 there
    (resolve_pallas.py:80-85), so the JAX reference rounds the records
    itself: its frame under the knob with `chunk_resolve_cols` wrapped to
    round the table with jnp (test_torch_knob_frames.rounded_records),
    and its resolve on jnp-rounded records
    against the port's plain bf16 resolve, with test_torch_resolve.py's
    tolerances. The port's bf16 frame moves off its default frame by more
    than the golden gate (its own result, which the golden gates forbid
    as a default); its readings are asserted.
"""

import numpy as np
import pytest
import torch

from trident_tpu_torch.ops import resolve
from trident_tpu_torch.ops.planes import records_from_reference

from test_torch_frame import _assert_golden_gate
from test_torch_knob_frames import (  # noqa: F401 (the fixture)
    Case,
    check_knob_frame,
    jax_frames,
    port_frame,
    rounded_records,
    scene,
)
from test_torch_resolve import _jax_resolve

torch.set_num_threads(1)

NOOP_KNOBS = {
    "resolve_skip": {"resolve_skip": True},
    "resolve_half": {"resolve_half": True},
    "resolve_compact": {"resolve_compact": True},
    "resolve_prec_fp32": {"resolve_prec": "fp32"},
    "resolve_tr": {"resolve_tr": False},
    "texel_mxu": {"texel_mxu": False},
    "texel_slab": {"texel_slab": 256},
    "texel_br": {"texel_br": 16},
    "texel_bc": {"texel_bc": 128},
}

BF16 = {"resolve_prec": "bf16"}


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return jax_frames(tmp_path_factory, {
        **{k: Case(v) for k, v in NOOP_KNOBS.items()},
        "shadow_mxu": Case({"shadow_mxu": False}, shadows=True),
        "bf16": Case(BF16, round_records=True)})


@pytest.mark.parametrize("name", sorted(NOOP_KNOBS))
def test_noop_knob_frame_matches_jax(name, scene, frames):  # noqa: F811
    check_knob_frame(NOOP_KNOBS[name], scene, frames[name])


def test_shadow_mxu_frame_matches_jax(scene, frames):  # noqa: F811
    """shadow_mxu=False on the shadowed scene (the JAX taps then gather the
    map per pixel; the JAX kernel engages at this 256² map)."""
    check_knob_frame({"shadow_mxu": False}, scene, frames["shadow_mxu"],
                     shadows=True)


def test_resolve_prec_bf16_frame(scene, frames):  # noqa: F811
    """The port's bf16 frame against the JAX frame under resolve_prec
    "bf16" with its records rounded: aux [0, 0], the golden gate; the fused
    pass gives the same frame; against the port's default frame it moves
    by more than the gate (the variant's own result), as the JAX frame of
    rounded records moves off the JAX default frame."""
    jr, default = scene[False]
    out = check_knob_frame(BF16, scene, frames["bf16"],
                           port_same_as_default=False)
    _tr, fused = port_frame(jr, kernel={**BF16, "fuse": True})
    assert torch.equal(fused.color, out.color)
    diff = np.abs(out.color.numpy().astype(int)
                  - default.color.numpy().astype(int))
    assert (diff > 3).mean() > 0.002, (diff > 3).mean()
    assert torch.equal(out.tri_id, default.tri_id)
    jdiff = np.abs(frames["bf16"][0].astype(int)
                   - frames["default"][0].astype(int))
    assert (jdiff > 3).mean() > 0.002


def test_plain_bf16_resolve_matches_jax_on_rounded_records():
    """The port's bf16 resolve (its plain version on the CPU) on the JAX
    records against the JAX resolve run in its default mode on those
    records rounded to bf16 with jnp, with test_torch_resolve.py's
    in-process tolerances: the material, texture and colour channels
    exact, normal and UV within 5e-5 of max(1, |value|), the mip level
    within 1e-4."""
    with rounded_records():
        cols, tri, jattrs = _jax_resolve()
    covered = tri >= 0
    assert covered.sum() > 3000
    records = records_from_reference(cols)
    pattrs = resolve.resolve_attrs(torch.from_numpy(tri), records,
                                   prec="bf16").numpy()
    assert (pattrs[~covered] == 0).all() and (jattrs[~covered] == 0).all()
    p, j = pattrs[covered], jattrs[covered]
    exact = list(range(resolve.CH_CF, resolve.CHANNELS))
    assert (p[:, exact] == j[:, exact]).all()
    for ch in range(resolve.CH_NX, resolve.CH_V + 1):
        err = np.abs(p[:, ch] - j[:, ch]) / np.maximum(1.0, np.abs(j[:, ch]))
        assert err.max() <= 5e-5, (ch, err.max())
    assert np.abs(p[:, resolve.CH_MIP] - j[:, resolve.CH_MIP]).max() <= 1e-4
    # the records really were rounded: the exact resolve differs
    exact_attrs = resolve.resolve_attrs(torch.from_numpy(tri),
                                        records).numpy()
    assert (exact_attrs[covered] != p).any()
    # every bf16 instance's wrapper on CPU tensors is its plain version on
    # the rounded table, in each layout
    rounded = resolve.bf16_records(records)
    t = torch.from_numpy(tri)
    assert torch.equal(resolve.resolve_attrs(t, records, 32, prec="bf16"),
                       resolve.resolve_attrs_plain(t, rounded, 32))
    tiles = t.reshape(-1, 1024)[:8].contiguous()
    assert torch.equal(
        resolve.resolve_attrs_tiled(tiles, records, 4, 1, prec="bf16"),
        resolve.resolve_attrs_tiled_plain(tiles, rounded, 4, 1))
