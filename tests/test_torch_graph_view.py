"""The port's animation graph view (trident_tpu_torch/anim/graph_view.py)
against the JAX package's, on the CPU.

Both packages build test_torch_anim.py's state machine (a base layer of a
clip, a Blend2 and a BlendSpace1D state with a trigger, an exit-time
transition and crossfades, and an additive masked upper layer) from the
same clips. describe_state_machine gives equal dicts before, during and
after the path through every state, with parameters written through each
package's set_parameter (float, trigger set and reset, bool, int); an
unknown parameter raises KeyError in both. describe_node of a node type
outside the blend tree names its type.
"""

import numpy as np
import pytest
import torch

from trident_tpu.anim import blend_tree as jbt
from trident_tpu.anim import data as jdata
from trident_tpu.anim import graph_view as jview
from trident_tpu.anim import state_machine as jsm
from trident_tpu_torch.anim import blend_tree as pbt
from trident_tpu_torch.anim import data as pdata
from trident_tpu_torch.anim import graph_view as pview
from trident_tpu_torch.anim import state_machine as psm

from test_anim_batch import busy_clip, chain_skeleton
from test_torch_anim import (
    _state_machine,
    port_clip,
    port_skeleton,
    seeded_rig,
)

torch.set_num_threads(1)


def _machines():
    jsk = chain_skeleton(4)
    jclips = [busy_clip(), busy_clip(duration=1.1), seeded_rig(bones=4)[1]]
    jm = _state_machine((jdata, jbt, jsm), (jsk, jclips))
    pm = _state_machine((pdata, pbt, psm), (port_skeleton(jsk),
                                            [port_clip(c) for c in jclips]))
    # a bool and an int besides
    jm.add_parameter("grounded", jsm.ParameterType.BOOL, 1.0)
    pm.add_parameter("grounded", psm.ParameterType.BOOL, 1.0)
    jm.add_parameter("lane", jsm.ParameterType.INT, 0.0)
    pm.add_parameter("lane", psm.ParameterType.INT, 0.0)
    return jm, pm


def test_describe_state_machine_matches_jax():
    jm, pm = _machines()
    views = []
    writes = {2: ("go", True), 6: ("speed", 0.8), 9: ("grounded", 0),
              11: ("lane", 2.7), 13: ("mix", 0.9), 17: ("speed", 1.6),
              19: ("go", True), 20: ("go", False)}
    for k in range(26):
        if k in writes:
            for view, m in ((jview, jm), (pview, pm)):
                view.set_parameter(m, *writes[k])
        jd = jview.describe_state_machine(jm)
        pd = pview.describe_state_machine(pm)
        assert pd == jd, f"step {k}"
        views.append(pd)
        jm.update(1 / 24)
        pm.update(1 / 24)
    base = [v["layers"][0]["current"] for v in views]
    assert base[0] == "idle" and "walk" in base and base[-1] == "run"
    assert any(v["layers"][0]["fading_from"] for v in views)
    params = {p["name"]: p for p in views[-1]["parameters"]}
    assert params["lane"]["value"] == 2.0 and params["grounded"]["value"] == 0
    assert params["go"]["value"] == 0.0
    assert [s["tree"]["type"] for s in views[0]["layers"][0]["states"]] == [
        "clip", "blend2", "blendspace1d"]


def test_set_parameter_unknown_raises():
    jm, pm = _machines()
    for view, m in ((jview, jm), (pview, pm)):
        with pytest.raises(KeyError, match="nope"):
            view.set_parameter(m, "nope", 1.0)


def test_describe_node_of_an_unknown_node():
    class Custom:
        pass

    assert pview.describe_node(Custom()) == jview.describe_node(Custom()) \
        == {"type": "Custom"}
    clip = busy_clip()
    node = pbt.ClipNode(port_clip(clip), speed=2.0)
    node.time = np.float64(0.12345)
    jnode = jbt.ClipNode(clip, speed=2.0)
    jnode.time = np.float64(0.12345)
    assert pview.describe_node(node) == jview.describe_node(jnode)
