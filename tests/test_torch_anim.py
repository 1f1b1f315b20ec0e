"""The port's animation system (trident_tpu_torch/anim, mathx/quat.py)
against the JAX package's, on the CPU.

  * quat: each function on torch tensors against the JAX function on the
    same arrays as jnp arrays, atol 1e-6; the numpy branch bit-equal to
    the JAX module's numpy branch (the same arithmetic on numpy).
  * the numpy pose code (pose.py, player.py): bit-equal to the JAX copy.
  * BatchedClipSampler against the JAX sampler on test_anim_batch.py's
    chain_skeleton(5) / busy_clip() and on a seeded clip and skeleton, at
    0, every key, the duration, beyond it, and 57 seeded times: atol 1e-5;
    against the port's AnimationPlayer at the same times: atol 3e-5 (the
    JAX test's tolerance, tests/test_anim_batch.py:79).
  * AnimationSystem: one sampler call per (skeleton, clip) group for 64
    instances over two updates, palettes equal to the JAX system's after
    the same updates (atol 1e-5); the state-machine path (layers, Blend2 /
    BlendSpace1D, triggers, transitions, an additive masked layer) frame
    for frame against the JAX one, atol 1e-5.
  * no fallback: a sampler asked for the card without one raises.

Both packages keep class-level state (AnimationAssetService, the
AnimationSystem's players and samplers): every test starts from a reset.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trident_tpu.anim import batch as jbatch
from trident_tpu.anim import blend_tree as jbt
from trident_tpu.anim import data as jdata
from trident_tpu.anim import pose as jpose
from trident_tpu.anim import state_machine as jsm
from trident_tpu.anim.player import AnimationPlayer as JPlayer
from trident_tpu.anim.service import AnimationAssetService as JService
from trident_tpu.anim.system import AnimationSystem as JSystem
from trident_tpu.ecs.components import AnimationComponent as JAnim
from trident_tpu.ecs.registry import Registry as JRegistry
from trident_tpu.mathx import quat as jquat

from trident_tpu_torch.anim import batch as pbatch
from trident_tpu_torch.anim import blend_tree as pbt
from trident_tpu_torch.anim import data as pdata
from trident_tpu_torch.anim import pose as ppose
from trident_tpu_torch.anim import state_machine as psm
from trident_tpu_torch.anim.player import AnimationPlayer
from trident_tpu_torch.anim.service import AnimationAssetService
from trident_tpu_torch.anim.system import AnimationSystem
from trident_tpu_torch.ecs.components import AnimationComponent
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.mathx import quat as pquat

from test_anim_batch import busy_clip, chain_skeleton

torch.set_num_threads(1)

SAMPLER_TOL = 1e-5       # port sampler against the JAX sampler
PLAYER_TOL = 3e-5        # sampler against the per-entity player
QUAT_TOL = 1e-6


def reset_animation_state():
    for service, system in ((JService, JSystem),
                            (AnimationAssetService, AnimationSystem)):
        service.reset()
        system._players = {}
        system._samplers = None
        system._SAMPLER_CAP = 32


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_animation_state()
    yield
    reset_animation_state()


# -- carrying JAX-package animation data across -------------------------------

def port_skeleton(sk) -> pdata.Skeleton:
    out = pdata.Skeleton(name=sk.name)
    for b in sk.bones:
        out.add_bone(pdata.Bone(name=b.name, source_name=b.source_name,
                                parent=b.parent,
                                local_bind=b.local_bind.copy(),
                                inverse_bind=b.inverse_bind.copy()))
    return out


def port_clip(clip) -> pdata.AnimationClip:
    chans = [pdata.TransformChannel(
        bone_name=c.bone_name,
        position_times=c.position_times.copy(), positions=c.positions.copy(),
        rotation_times=c.rotation_times.copy(), rotations=c.rotations.copy(),
        scale_times=c.scale_times.copy(), scales=c.scales.copy())
        for c in clip.channels]
    return pdata.AnimationClip(name=clip.name, duration=clip.duration,
                               channels=chans)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _trs(rng):
    """A seeded local transform: translation, rotation, positive scale."""
    m = np.eye(4, dtype=np.float32)
    q = _unit_quats(rng, 1)[0]
    s = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    m[:3, :3] = np.asarray(jquat.quat_to_mat3(q)) * s[None, :]
    m[:3, 3] = rng.uniform(-1, 1, 3)
    return m


def seeded_rig(seed=7, bones=9, duration=1.6):
    """(skeleton, clip) of the JAX package from a numpy seed: a tree of
    `bones` bones (each parent an earlier bone), seeded local binds and
    inverse binds, and channels with 0 to 6 seeded keys per track on all
    bones but two (an empty track keeps the bind value; key times sorted in [0, duration],
    the last at duration on some tracks only)."""
    rng = np.random.default_rng(seed)
    sk = jdata.Skeleton(name="seeded")
    for i in range(bones):
        parent = -1 if i == 0 else int(rng.integers(0, i))
        inv = np.linalg.inv(_trs(rng)).astype(np.float32)
        sk.add_bone(jdata.Bone(name=f"b{i}", source_name=f"mixamorig:b{i}",
                               parent=parent, local_bind=_trs(rng),
                               inverse_bind=inv))
    chans = []
    for i in range(bones - 2):
        def keys(k):
            t = np.sort(rng.uniform(0.0, duration, k)).astype(np.float32)
            if k and rng.random() < 0.5:
                t[-1] = duration
            return t
        kp, kr, ks = (int(x) for x in rng.integers(0, 7, 3))
        chans.append(jdata.TransformChannel(
            bone_name=f"mixamorig:b{i}" if i % 2 else f"b{i}",
            position_times=keys(kp),
            positions=rng.uniform(-2, 2, (kp, 3)).astype(np.float32),
            rotation_times=keys(kr), rotations=_unit_quats(rng, kr),
            scale_times=keys(ks),
            scales=rng.uniform(0.5, 2.0, (ks, 3)).astype(np.float32)))
    return sk, jdata.AnimationClip(name="seeded", duration=duration,
                                   channels=chans)


RIGS = {"busy": lambda: (chain_skeleton(5), busy_clip()),
        "seeded": seeded_rig}


def sample_times(clip, seed=11) -> np.ndarray:
    """0, every key, the duration, beyond it, and 57 seeded times."""
    keys = np.concatenate([np.concatenate([c.position_times,
                                           c.rotation_times, c.scale_times])
                           for c in clip.channels])
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.array([0.0, clip.duration, clip.duration + 0.75], np.float32),
        np.unique(keys).astype(np.float32),
        rng.uniform(0.0, clip.duration, 57).astype(np.float32)])


# -- quat ---------------------------------------------------------------------

def _quat_cases():
    rng = np.random.default_rng(3)
    a, b = _unit_quats(rng, 64), _unit_quats(rng, 64)
    # near-parallel pairs (the nlerp branch) and opposite signs
    b[:8] = a[:8] + rng.normal(0, 1e-7, (8, 4)).astype(np.float32)
    b[8:16] = -a[8:16]
    t = rng.uniform(0, 1, 64).astype(np.float32)
    euler = rng.uniform(-180, 180, (64, 3)).astype(np.float32)
    raw = rng.normal(size=(64, 4)).astype(np.float32) * 3
    raw[0] = 0.0
    return {
        "quat_identity": (),
        "quat_normalize": (raw,),
        "quat_mul": (a, b),
        "quat_from_euler_deg": (euler,),
        "quat_to_mat3": (raw,),
        "quat_slerp": (a, b, t),
    }


@pytest.mark.parametrize("name", sorted(_quat_cases()))
def test_quat_torch_matches_jax(name):
    args = _quat_cases()[name]
    pfn, jfn = getattr(pquat, name), getattr(jquat, name)
    if name == "quat_identity":
        got, ref = pfn(torch), jfn(jnp)
    else:
        got = pfn(*(torch.from_numpy(a) for a in args))
        ref = jfn(*(jnp.asarray(a) for a in args))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=QUAT_TOL,
                               rtol=0)
    if args:       # the numpy branch: the same arithmetic as the JAX one's
        got_np = pfn(*args)
        assert isinstance(got_np, np.ndarray)
        assert np.array_equal(got_np, np.asarray(jfn(*args)))


# -- the numpy pose code ------------------------------------------------------

def test_pose_and_player_bit_equal_to_jax():
    jsk, jclip = seeded_rig(seed=5)
    sk, clip = port_skeleton(jsk), port_clip(jclip)
    rng = np.random.default_rng(2)
    for t in rng.uniform(0, clip.duration, 6):
        a = ppose.sample_clip_pose(clip, sk, float(t))
        ja = jpose.sample_clip_pose(jclip, jsk, float(t))
        b = ppose.sample_clip_pose(clip, sk, float(t) * 0.5)
        jb = jpose.sample_clip_pose(jclip, jsk, float(t) * 0.5)
        mask = rng.uniform(0, 1, len(sk)).astype(np.float32)
        pairs = [
            (ppose.blend_pose(a, b, 0.3, mask), jpose.blend_pose(ja, jb, 0.3, mask)),
            (ppose.additive_pose(a, b, ppose.Pose.bind(sk), 0.6, mask),
             jpose.additive_pose(ja, jb, jpose.Pose.bind(jsk), 0.6, mask)),
        ]
        for p, j in [(a, ja)] + pairs:
            for f in ("position", "rotation", "scale"):
                assert np.array_equal(getattr(p, f), getattr(j, f))
        assert np.array_equal(ppose.compose_skinning_matrices(a, sk),
                              jpose.compose_skinning_matrices(ja, jsk))
    player, jplayer = AnimationPlayer(sk), JPlayer(jsk)
    for pl in (player, jplayer):
        pl.set_clip(clip if pl is player else jclip)
        pl.play()
    for dt in (0.1, 0.7, 1.3):
        assert np.array_equal(player.update(dt), jplayer.update(dt))
        assert player.time == jplayer.time


# -- the batched sampler ------------------------------------------------------

@pytest.mark.parametrize("rig", sorted(RIGS))
def test_sampler_matches_jax_sampler(rig):
    jsk, jclip = RIGS[rig]()
    times = sample_times(jclip)
    sampler = pbatch.BatchedClipSampler(port_clip(jclip), port_skeleton(jsk),
                                        device="cpu")
    assert sampler.device == torch.device("cpu")
    got = sampler(times)
    ref = jbatch.BatchedClipSampler(jclip, jsk)(times)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == ref.shape == (len(times), len(jsk), 4, 4)
    np.testing.assert_allclose(got, ref, atol=SAMPLER_TOL, rtol=0)


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_sampler_matches_player(rig):
    jsk, jclip = RIGS[rig]()
    sk, clip = port_skeleton(jsk), port_clip(jclip)
    times = sample_times(clip)
    got = pbatch.BatchedClipSampler(clip, sk, device="cpu")(times)
    player = AnimationPlayer(sk)
    player.set_clip(clip)
    player.looping = False      # clamp: the sampler takes wrapped times
    for t, pal in zip(times, got):
        np.testing.assert_allclose(pal, player.evaluate_at(float(t)),
                                   atol=PLAYER_TOL, rtol=0, err_msg=f"t={t}")


def test_sampler_takes_any_instance_count():
    """No power-of-two bucket: each call returns exactly N palettes, and
    one instance alone equals its row of a larger call."""
    jsk, jclip = seeded_rig()
    sampler = pbatch.BatchedClipSampler(port_clip(jclip), port_skeleton(jsk),
                                        device="cpu")
    times = sample_times(jclip)
    full = sampler(times)
    for n in (1, 5, 7):
        out = sampler(times[:n])
        assert out.shape[0] == n
        np.testing.assert_array_equal(out, full[:n])


def test_sampler_raises_without_the_card(monkeypatch):
    """The sampler runs where it is told: a CUDA request without a card
    raises, and so does the system's default device (the card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jsk, jclip = chain_skeleton(3), busy_clip()
    sk, clip = port_skeleton(jsk), port_clip(jclip)
    with pytest.raises(RuntimeError, match="cuda"):
        pbatch.BatchedClipSampler(clip, sk)
    with pytest.raises(RuntimeError, match="cuda"):
        pbatch.BatchedClipSampler(clip, sk, device="cuda")
    AnimationAssetService.get().register_runtime_asset("rig", sk, [clip])
    reg = Registry()
    reg.add(reg.create(), AnimationComponent(skeleton_asset="rig",
                                             playing=True))
    with pytest.raises(RuntimeError, match="cuda"):
        AnimationSystem.update(reg, 0.1)


# -- the animation system -----------------------------------------------------

def _two_group_registries(n=64):
    """The same n entities in a JAX and a port registry: two clips of one
    skeleton (a group each), distinct speeds, one paused entity and one
    clamped (non-looping) one."""
    jsk = chain_skeleton(4)
    jclips = [busy_clip(), busy_clip(duration=1.3)]
    jclips[1].name = "short"
    JService.get().register_runtime_asset("rig", jsk, jclips)
    AnimationAssetService.get().register_runtime_asset(
        "rig", port_skeleton(jsk), [port_clip(c) for c in jclips])
    jreg, reg = JRegistry(), Registry()
    for i in range(n):
        kw = dict(skeleton_asset="rig", clip_index=int(i % 3 == 0),
                  speed=0.5 + 0.01 * i, playing=i != 5, looping=i != 7)
        jreg.add(jreg.create(), JAnim(**kw))
        reg.add(reg.create(), AnimationComponent(**kw))
    return jreg, reg


def test_system_one_sampler_call_per_group(monkeypatch):
    jreg, reg = _two_group_registries()
    calls = []
    orig = pbatch.BatchedClipSampler.__call__

    def counted(self, times):
        calls.append((self.clip.name, len(times)))
        return orig(self, times)

    monkeypatch.setattr(pbatch.BatchedClipSampler, "__call__", counted)
    for dt in (0.25, 0.6):
        AnimationSystem.update(reg, dt, device="cpu")
        JSystem.update(jreg, dt)
    playing = [a for _e, (a,) in reg.view(AnimationComponent) if a.playing]
    n_short = sum(a.clip_index == 1 for a in playing)
    assert sorted(calls) == sorted([("busy", len(playing) - n_short),
                                    ("short", n_short)] * 2)
    assert {k[2] for k in AnimationSystem._samplers} == {"cpu"}
    for (_e, (a,)), (_je, (ja,)) in zip(reg.view(AnimationComponent),
                                        jreg.view(JAnim)):
        assert a.time == pytest.approx(ja.time, abs=1e-9)
        if not a.playing:
            assert a.bone_matrices is None and ja.bone_matrices is None
            continue
        np.testing.assert_allclose(a.bone_matrices, ja.bone_matrices,
                                   atol=SAMPLER_TOL, rtol=0)


def test_initialise_pose_matches_jax():
    """Play's first pose: each entity at its current time, sampled on the
    given device, within the sampler tolerance of the JAX per-entity
    evaluation."""
    jreg, reg = _two_group_registries(n=12)
    for (_e, (a,)), (_je, (ja,)) in zip(reg.view(AnimationComponent),
                                        jreg.view(JAnim)):
        a.time = ja.time = 0.37 * a.speed
    AnimationSystem.initialise_pose(reg, device="cpu")
    JSystem.initialise_pose(jreg)
    for (_e, (a,)), (_je, (ja,)) in zip(reg.view(AnimationComponent),
                                        jreg.view(JAnim)):
        np.testing.assert_allclose(a.bone_matrices, ja.bone_matrices,
                                   atol=SAMPLER_TOL, rtol=0)


def _state_machine(mods, jsk_clips):
    """One state machine of package `mods` (data, blend_tree,
    state_machine): a base layer (idle clip → walk Blend2 on a trigger,
    walk → run BlendSpace1D when speed > 0.5 with exit time and a fade)
    and an additive upper layer at weight 0.6 with a bone mask."""
    data, bt, sm_mod = mods
    sk, (c0, c1, c2) = jsk_clips
    sm = sm_mod.AnimationStateMachine(sk)
    sm.add_parameter("go", sm_mod.ParameterType.TRIGGER)
    sm.add_parameter("speed", sm_mod.ParameterType.FLOAT, 0.0)
    sm.add_parameter("mix", sm_mod.ParameterType.FLOAT, 0.25)
    base = sm.add_layer(sm_mod.Layer("base"))
    base.add_state(sm_mod.State("idle", bt.ClipNode(c0, speed=0.5)),
                   default=True)
    base.add_state(sm_mod.State("walk", bt.Blend2Node(
        bt.ClipNode(c0), bt.ClipNode(c1, speed_parameter="speed"), "mix")))
    base.add_state(sm_mod.State("run", bt.BlendSpace1DNode("speed", [
        bt.BlendSample(0.0, bt.ClipNode(c1)),
        bt.BlendSample(1.0, bt.ClipNode(c2, looping=False)),
        bt.BlendSample(2.0, bt.ClipNode(c0, speed=1.5))])))
    base.add_transition(sm_mod.Transition("idle", "walk", [
        sm_mod.Condition("go", sm_mod.Comparison.TRIGGERED)],
        fade_duration=0.3))
    base.add_transition(sm_mod.Transition("walk", "run", [
        sm_mod.Condition("speed", sm_mod.Comparison.GREATER, 0.5)],
        has_exit_time=True, exit_time=0.2, fade_duration=0.25))
    upper = sm.add_layer(sm_mod.Layer(
        "upper", weight=0.6, additive=True,
        mask=np.array([0.0, 1.0, 1.0, 0.5], np.float32)))
    upper.add_state(sm_mod.State("wave", bt.ClipNode(c2)), default=True)
    return sm


def test_state_machine_path_matches_jax():
    """Frame for frame through AnimationSystem.update: parameters and a
    trigger set between frames, crossfades and exit times crossed."""
    jsk = chain_skeleton(4)
    jclips = [busy_clip(), busy_clip(duration=1.1), seeded_rig(bones=4)[1]]
    jm = _state_machine((jdata, jbt, jsm), (jsk, jclips))
    pm = _state_machine((pdata, pbt, psm), (port_skeleton(jsk),
                                            [port_clip(c) for c in jclips]))
    jreg, reg = JRegistry(), Registry()
    jreg.add(jreg.create(), JAnim(playing=True, state_machine=jm))
    reg.add(reg.create(), AnimationComponent(playing=True, state_machine=pm))
    steps = {3: ("go", None), 8: ("speed", 0.8), 14: ("mix", 0.9),
             20: ("speed", 1.6)}
    layers = []
    for k in range(30):
        if k in steps:
            name, v = steps[k]
            for m in (jm, pm):
                m.set_trigger(name) if v is None else m.set_float(name, v)
        JSystem.update(jreg, 1 / 24)
        AnimationSystem.update(reg, 1 / 24, device="cpu")
        ja = next(a for _e, (a,) in jreg.view(JAnim))
        pa = next(a for _e, (a,) in reg.view(AnimationComponent))
        np.testing.assert_allclose(pa.bone_matrices, ja.bone_matrices,
                                   atol=SAMPLER_TOL, rtol=0,
                                   err_msg=f"frame {k}")
        assert pa.time == pytest.approx(ja.time, abs=1e-12)
        assert [l.current for l in pm.layers] == [l.current for l in jm.layers]
        layers.append(pm.layers[0].current)
    # the path crossed every state and consumed the trigger
    assert layers[0] == "idle" and "walk" in layers and layers[-1] == "run"
    assert pm.parameters["go"] == 0.0
