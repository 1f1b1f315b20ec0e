"""A whole run (the card's look skipped: on the CPU at 128²) comes out
correct, and with the timed path broken underneath it comes out not
correct: once for each fault a cell can have. One card, so no exchange
between cards can be left out."""

import pytest
import torch

from benchmark import harness
from benchmark.conftest import CELLS


def state_unchanged(scene, loop):
    """Every step leaves the scene as it was: no transform changes, no
    animation update."""
    scene.step = lambda k: None


def half_left_out(scene, loop):
    """Every other drawn entity is left out of the frames."""
    from trident_tpu_torch.ecs.components import MeshComponent

    reg = scene.renderer.registry
    for i, (_e, (mesh,)) in enumerate(reg.view(MeshComponent)):
        if i % 2:
            mesh.visible = False


def answer_altered(scene, loop):
    """Each frame's first 32×32 pixels altered where the frame is
    produced (bit 6 of every colour value flipped)."""
    frame = loop.frame

    def altered(k):
        out = frame(k)
        color = out.color.clone()
        color[:32, :32, :3] ^= 0x40
        return out._replace(color=color)

    loop.frame = altered


def run(cell, small, hook=None):
    return harness.run_cell(cell, 424242424242, 0.3, False, "cpu",
                            hook=hook, config=small(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, small):
    out = run(cell, small)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, small):
    out = run(cell, small, fault)
    assert not out["correct"], out["checks"]


def test_drop_counters_fail_a_frame(small):
    """A frame whose drop counters are not [0, 0] counts as failed."""
    def dropped(scene, loop):
        frame = loop.frame

        def counted(k):
            out = frame(k)
            return out._replace(aux=torch.tensor([1, 0], dtype=torch.int32))

        loop.frame = counted

    out = run("field1m_1080.dynamic", small, dropped)
    assert out["failed"] == out["attempted"] and not out["correct"]
