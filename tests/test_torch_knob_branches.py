"""Every kernel knob the JAX package accepts renders in the port: the
visibility and binning branches that the JAX tests pin bit-exact to the
default (qgate, recpad, rect, treset=False: tests/test_raster_pallas_cpu
.py:311, 388, 400, 658; exact_bins, sort_pad: :484, :676), cover_gate,
and the visibility structures the port validated before (dynhit, acc,
zskip, zorder), each held against the JAX Renderer's frame under the same
knob on test_torch_knob_frames.py's scene and gates (its no-FMA child).
On the card none of them selects anything: the port's frame under each is
its default frame bit for bit.

cover_gate (raster_pallas.py:106-112) skips only the sub-blocks that
cover no pixel, and no JAX test pins it: here its JAX frame is held bit
for bit to the JAX default frame first.
"""

import pytest
import torch

from test_torch_knob_frames import (  # noqa: F401 (the fixture)
    Case,
    check_knob_frame,
    jax_frames,
    scene,
)

torch.set_num_threads(1)

# id → RenderConfig.kernel (dynhit off where the JAX rules require it)
BRANCH_KNOBS = {
    "sort_pad": {"sort_pad": True},
    "exact_bins": {"exact_bins": True},
    "qgate": {"qgate": True, "dynhit": False},
    "recpad": {"recpad": True},
    "rect": {"rect": True, "dynhit": False},
    "treset": {"treset": False},
    "dynhit": {"dynhit": False},
    "acc": {"acc": False, "dynhit": False},
    "zskip_zorder": {"zskip": True, "zorder": True},
}


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return jax_frames(tmp_path_factory, {
        **{k: Case(v) for k, v in BRANCH_KNOBS.items()},
        "cover_gate": Case({"cover_gate": True})})


@pytest.mark.parametrize("name", sorted(BRANCH_KNOBS))
def test_branch_knob_frame_matches_jax(name, scene, frames):  # noqa: F811
    check_knob_frame(BRANCH_KNOBS[name], scene, frames[name])


def test_cover_gate_is_pinned_to_the_default(scene, frames):  # noqa: F811
    """The JAX frame under cover_gate equals the JAX default frame bit for
    bit, so on the card it is a no-op like the branches the JAX tests
    pin; the port's frame under it against it."""
    assert frames["cover_gate"][1] == [0, 0]
    assert (frames["cover_gate"][0] == frames["default"][0]).all()
    check_knob_frame({"cover_gate": True}, scene, frames["cover_gate"])
