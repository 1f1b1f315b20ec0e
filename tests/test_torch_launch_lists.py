"""The frame graphs' launch lists (render/graphs.py): what a capture
records, from _build.LAUNCHES restricted to graphs.LISTED, per route.

On the card (marker `card`; there: python3 -m pytest --noconftest -m card
tests/test_torch_launch_lists.py) each route renders two 128² frames
through Renderer.render_viewport, one capture and its replays, and its
graphs' `last_launches` after each frame, `captured` and `replayed` must
be the dicts below, measured on an NVIDIA H100 80GB HBM3. Routes: the
golden base scene (tools_dev/scenes.py::golden_base_scene) at the
default knobs, under `fuse`, `ckern` and `tiled_shade`, each of those
three kinds of resolve with resolve_prec "bf16", and the vertex-coloured
skinned crowd (scenes.SKINNED_128) posed anew each frame, at the default
knobs, under `fuse` and with bf16. The skinned pair, the shading kernel,
the binning kernels and the stage marks launch in these captures too and
are on no list.

On the CPU: every instance name the resolve entry points form
(ops/resolve.py::_instance) and every name on the lists is a C entry
point of csrc/, and the kernels kept off the lists are entry points too.

No JAX here."""

import itertools
import re

import pytest
import torch

from trident_tpu_torch import _build
from trident_tpu_torch.ops import resolve
from trident_tpu_torch.render import graphs
from trident_tpu_torch.tools_dev import scenes

CKERN = {"ckern": True, "dynhit": False}
# route → (scene, kernel knobs, the launch list of each frame's graph,
# the launches the two frames' replays ran)
ROUTES = {
    "default": ("base", None, {"visibility": 1, "resolve": 1}, 1),
    "fuse": ("base", {"fuse": True}, {"visibility_resolve": 1}, 1),
    "ckern": ("base", CKERN, {"visibility_ck": 1, "resolve": 1}, 1),
    "tiled_shade": ("base", {"tiled_shade": True},
                    {"visibility": 1, "resolve_tiled": 1,
                     "texel_planar": 1}, 1),
    "bf16": ("base", {"resolve_prec": "bf16"},
             {"visibility": 1, "resolve_bf16": 1}, 1),
    "fuse_bf16": ("base", {"fuse": True, "resolve_prec": "bf16"},
                  {"visibility_resolve_bf16": 1}, 1),
    "tiled_shade_bf16": ("base", {"tiled_shade": True,
                                  "resolve_prec": "bf16"},
                         {"visibility": 1, "resolve_tiled_bf16": 1,
                          "texel_planar": 1}, 1),
    "skinned_vc": ("skinned", None, {"visibility": 1, "resolve_vc": 1}, 2),
    "skinned_vc_fuse": ("skinned", {"fuse": True},
                        {"visibility_resolve_vc": 1}, 2),
    "skinned_vc_bf16": ("skinned", {"resolve_prec": "bf16"},
                        {"visibility": 1, "resolve_vc_bf16": 1}, 2),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; where there is one: python3 -m "
                    "pytest --noconftest -m card "
                    "tests/test_torch_launch_lists.py")
    _build.load_library()
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_card_route_launch_list(card, route):
    scene, knobs, expect, replays = ROUTES[route]
    if scene == "base":
        r, reg = scenes.golden_base_scene(card, kernel=knobs), None
    else:
        r, reg = scenes.skinned_scene(card, kernel=knobs,
                                      **scenes.SKINNED_128)
    before = dict(_build.LAUNCHES)
    for k in range(2):
        if reg is not None:
            scenes.pose_skinned(reg, k, scenes.SKINNED_128["bones"])
        r.render_viewport()
        torch.cuda.synchronize()
        assert r.graphs.last_launches == expect, (route, k)
    assert r.graphs.captures == 1
    assert dict(r.graphs.captured) == expect
    assert dict(r.graphs.replayed) == {n: c * replays
                                       for n, c in expect.items()}
    # the capture is the only time a listed entry point launched; its
    # eager warm-up launched each once more
    ran = {n[len("trident_"):]: c - before.get(n, 0)
           for n, c in _build.LAUNCHES.items() if c != before.get(n, 0)}
    assert {n: c for n, c in ran.items() if n in expect} == {
        n: 2 * c for n, c in expect.items()}


def _entry_points() -> set:
    src = "\n".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    return set(re.findall(r'extern "C" int (trident_\w+)\(', src))


@pytest.mark.parametrize("base", ("trident_resolve", "trident_resolve_tiled",
                                  "trident_visibility_resolve"))
def test_every_resolve_instance_is_a_listed_entry_point(base):
    entries = _entry_points()
    for vc, offset, prec in itertools.product((False, True), (None, 0, 3),
                                              resolve.PRECS):
        name = resolve._instance(base, vc, offset, prec)
        assert name in entries, (vc, offset, prec)
        assert name[len("trident_"):] in graphs.LISTED


def test_listed_names_are_entry_points():
    entries = _entry_points()
    assert {"trident_" + n for n in graphs.LISTED} <= entries
    unlisted = {"trident_skinned_vertices", "trident_skinned_triangles",
                "trident_rigid_geometry",
                "trident_deferred_shade", "trident_stage_mark",
                "trident_bin_records", "trident_bin_claims",
                "trident_bin_heads", "trident_bin_pairs"}
    assert unlisted <= entries
    assert not {n[len("trident_"):] for n in unlisted} & graphs.LISTED
