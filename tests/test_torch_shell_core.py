"""The port's host shell modules against the JAX package's, on the CPU:
core/{events,input,filewatch,threadcheck,alloc}.py and ecs/inspect.py.

  * events and input: the same event sequences (made with numpy from a
    seed) leave equal Input states and equal dispatch results; the
    Input.get() singleton (restored after the test);
  * filewatch: the same file edits with poll(now=) and set mtimes give
    equal ReloadEvent streams, preserved (older) timestamps included;
  * threadcheck: a cross-thread Registry.add raises ThreadAffinityError,
    rebind_thread hands ownership over (tests/test_threadcheck.py's
    behaviour on the port's Registry; the guard is switched off after);
  * inspect: a registry carried across with from_reference gives equal
    list_entity dicts, schemas, coerced values and set_field errors;
  * alloc: host tracking, and (0, 0) device bytes for the CPU.
"""

import os
import threading

import numpy as np
import pytest
import torch

from trident_tpu.core import events as jev
from trident_tpu.core import filewatch as jfw
from trident_tpu.core.input import Input as JInput
from trident_tpu.ecs import components as jc
from trident_tpu.ecs import inspect as jinspect
from trident_tpu.ecs.registry import Registry as JRegistry

from trident_tpu_torch.core import alloc
from trident_tpu_torch.core import events as ev
from trident_tpu_torch.core import filewatch as fw
from trident_tpu_torch.core import threadcheck
from trident_tpu_torch.core.input import Input
from trident_tpu_torch.ecs import components as C
from trident_tpu_torch.ecs import inspect
from trident_tpu_torch.ecs.registry import Registry, from_reference

torch.set_num_threads(1)

EVENT_KINDS = ("KeyPressedEvent", "KeyReleasedEvent", "MouseMovedEvent",
               "MouseScrolledEvent", "MouseButtonPressedEvent",
               "MouseButtonReleasedEvent")


def event_script(seed: int, n: int = 60):
    """(kind, kwargs) pairs and frame breaks ("frame", {}) from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, len(EVENT_KINDS) + 1))
        if k == len(EVENT_KINDS):
            out.append(("frame", {}))
            continue
        kind = EVENT_KINDS[k]
        if kind.startswith("Key"):
            kw = dict(key=int(rng.integers(0, 5)))
            if kind == "KeyPressedEvent":
                kw["repeat"] = bool(rng.random() < 0.3)
        elif kind == "MouseMovedEvent":
            kw = dict(x=float(rng.uniform(0, 640)), y=float(rng.uniform(0, 480)))
        elif kind == "MouseScrolledEvent":
            kw = dict(dx=float(rng.normal()), dy=float(rng.normal()))
        else:
            kw = dict(button=int(rng.integers(0, 3)))
        out.append((kind, kw))
    return out


def input_state(inp) -> dict:
    keys, buttons = range(5), range(3)
    return dict(
        down=[inp.key_down(k) for k in keys],
        pressed=[inp.key_pressed(k) for k in keys],
        released=[inp.key_released(k) for k in keys],
        repeated=[inp.key_repeated(k) for k in keys],
        mdown=[inp.mouse_down(b) for b in buttons],
        mpressed=[inp.mouse_pressed(b) for b in buttons],
        mreleased=[inp.mouse_released(b) for b in buttons],
        pos=inp.mouse_position, delta=inp.mouse_delta, scroll=inp.scroll)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_sequences_leave_equal_input_states(seed):
    j, p = JInput(), Input()
    for kind, kw in event_script(seed):
        if kind == "frame":
            j.end_frame(), p.end_frame()
            j.begin_frame(), p.begin_frame()
        else:
            j.on_event(getattr(jev, kind)(**kw))
            p.on_event(getattr(ev, kind)(**kw))
        assert input_state(p) == input_state(j)
    j.ui_capturing_keyboard = p.ui_capturing_keyboard = True
    j.ui_capturing_mouse = p.ui_capturing_mouse = True
    assert input_state(p) == input_state(j)


def test_input_singleton_and_mouse_delta_survives_begin_frame():
    saved = Input._instance
    try:
        Input._instance = None
        a = Input.get()
        assert Input.get() is a
        a.on_event(ev.MouseMovedEvent(x=10.0, y=4.0))
        a.begin_frame()                        # events arrive between frames
        assert a.mouse_delta == (10.0, 4.0)
        a.end_frame()
        assert a.mouse_delta == (0.0, 0.0)
    finally:
        Input._instance = saved


def test_dispatcher_matches_jax():
    calls = {"j": [], "p": []}
    for mod, tag in ((jev, "j"), (ev, "p")):
        d = mod.EventDispatcher()
        d.subscribe(mod.KeyPressedEvent,
                    lambda e, t=tag: calls[t].append(("a", e.key)) or e.key == 3)
        d.subscribe(mod.KeyPressedEvent,
                    lambda e, t=tag: calls[t].append(("b", e.key)) or False)
        d.subscribe(mod.WindowResizeEvent,
                    lambda e, t=tag: calls[t].append(("r", e.width)) or True)
        results = [d.dispatch(mod.KeyPressedEvent(key=k)) for k in (1, 3)]
        results.append(d.dispatch(mod.WindowResizeEvent(width=7, height=2)))
        results.append(d.dispatch(mod.FileDropEvent(paths=["x"])))
        calls[tag].append(results)
    assert calls["p"] == calls["j"]
    assert [t.name for t in ev.EventType] == [t.name for t in jev.EventType]
    assert ev.AssetReloadedEvent(path="p", kind="model").type.name == \
        "ASSET_RELOADED"


def _events(watcher):
    out = []
    while (e := watcher.pop_pending()) is not None:
        out.append((e.event_id, e.kind.name, e.path, e.status.name))
    return out


def test_filewatch_streams_match_jax(tmp_path):
    """The same edits, in the same order with explicit mtimes, seen by a
    JAX and a port watcher polled at the same `now`."""
    root = tmp_path / "Assets"
    for sub in ("Textures", "Models", "Shaders", "Late"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(11)

    def touch(rel, mtime):
        p = root / rel
        p.write_bytes(rng.bytes(8))
        os.utime(p, (mtime, mtime))

    touch("Textures/a.png", 1000.0)
    touch("Models/m.obj", 1000.0)
    touch("Shaders/s.py", 1000.0)
    touch("Textures/ignored.txt", 1000.0)
    watchers = [jfw.FileWatcher(poll_interval=0.5),
                fw.FileWatcher(poll_interval=0.5)]
    for w, mod in zip(watchers, (jfw, fw)):
        for sub, kind in (("Textures", "TEXTURE"), ("Models", "MODEL"),
                          ("Shaders", "SHADER")):
            w.watch(str(root / sub), mod.ReloadType[kind])
        # the shader directory also as a texture watch of .py files: one
        # file, two subsystems' events
        w.watch(str(root / "Shaders"), mod.ReloadType.TEXTURE, [".PY"])
    edits = [
        (1.0, []),                                         # baseline
        (1.2, [("Textures/a.png", 1001.0)]),               # rate-limited
        (1.6, []),                                         # sees a.png
        (2.2, [("Models/m.obj", 900.0)]),                  # preserved, older
        (2.8, [("Shaders/s.py", 1002.0), ("Textures/b.png", 5.0)]),
        (3.4, [("Textures/ignored.txt", 2000.0)]),
        (4.0, [("Late/l.png", 1.0)]),                      # new watch below
        (4.6, [("Late/l.png", 2.0), ("Textures/a.png", 1001.0)]),
    ]
    streams = [[], []]
    for now, changes in edits:
        for rel, mtime in changes:
            touch(rel, mtime)
        if now == 4.0:
            for w, mod in zip(watchers, (jfw, fw)):
                w.watch(str(root / "Late"), mod.ReloadType.TEXTURE)
        for w, s in zip(watchers, streams):
            queued = w.poll(now=now)
            s.append((queued, w.pending_count(), _events(w)))
    assert streams[1] == streams[0]
    assert sum(q for q, _n, _e in streams[1]) >= 6
    assert fw.DEFAULT_EXTENSIONS == {fw.ReloadType[k.name]: v for k, v in
                                     jfw.DEFAULT_EXTENSIONS.items()}


def _in_thread(fn):
    out = {}

    def runner():
        try:
            fn()
            out["error"] = None
        except Exception as exc:  # noqa: BLE001 — the test reads it
            out["error"] = exc

    t = threading.Thread(target=runner, name="worker")
    t.start()
    t.join()
    return out["error"]


@pytest.fixture
def guard():
    yield threadcheck
    threadcheck.set_active(threadcheck.checks_enabled())


def test_cross_thread_add_raises_and_rebind_hands_over(guard):
    guard.install_registry_guard()
    reg = Registry()
    e = reg.create()
    reg.add(e, C.TransformComponent())           # owner = this thread
    err = _in_thread(lambda: reg.add(e, C.TagComponent("bad")))
    assert isinstance(err, guard.ThreadAffinityError)
    assert "add" in str(err)
    assert reg.get(e, C.TransformComponent) is not None   # reads unguarded

    def handoff():
        reg.rebind_thread()
        reg.add(e, C.TagComponent("ok"))
        reg.destroy(reg.create())

    assert _in_thread(handoff) is None
    with pytest.raises(guard.ThreadAffinityError):
        reg.create()                             # no longer the owner
    guard.set_active(False)
    reg.create()                                 # inactive: anything goes


def test_guard_rebind_and_env_switch(guard, monkeypatch):
    g = guard.ThreadGuard("test")
    g.check()
    assert isinstance(_in_thread(lambda: g.check("poke")),
                      guard.ThreadAffinityError)
    assert _in_thread(lambda: (g.rebind(), g.check())) is None
    with pytest.raises(guard.ThreadAffinityError):
        g.check()
    for value, on in (("", False), ("0", False), ("false", False),
                      ("1", True)):
        monkeypatch.setenv("TRIDENT_THREAD_CHECKS", value)
        assert guard.checks_enabled() is on


def _scene(reg, rng):
    """Every component kind on two entities, fields drawn from rng."""
    e = reg.create()
    t = reg.add(e, jc.TransformComponent())
    t.position = rng.normal(size=3).astype(np.float32)
    t.rotation = rng.uniform(0, 90, 3).astype(np.float32)
    reg.add(e, jc.MeshComponent(mesh_index=int(rng.integers(0, 9))))
    reg.add(e, jc.TextureComponent(path="checker", slot=2))
    reg.add(e, jc.TagComponent(tag="hero"))
    reg.add(e, jc.LightComponent(light_type=jc.LightType.POINT,
                                 intensity=float(rng.uniform(1, 3))))
    f = reg.create()
    reg.add(f, jc.TransformComponent())
    reg.add(f, jc.CameraComponent(primary=True))
    reg.add(f, jc.SpriteComponent())
    reg.add(f, jc.ScriptComponent())
    reg.add(f, jc.AnimationComponent(clip_name="walk"))
    return e, f


BAD_WRITES = [("Transform", "position", [1, 2]),
              ("Transform", "position", [1, float("nan"), 3]),
              ("Light", "light_type", "spot"),
              ("Light", "intensity", float("inf")),
              ("Mesh", "nonexistent", 1),
              ("Animation", "bone_matrices", [1]),
              ("Nope", "x", 1)]
GOOD_WRITES = [("Transform", "position", [1, 2, 3]),
               ("Light", "light_type", "directional"),
               ("Light", "light_type", 1),
               ("Mesh", "visible", "false"),
               ("Mesh", "mesh_index", "7"),
               ("Light", "intensity", "2.5"),
               ("Tag", "tag", 42),
               ("Texture", "path", "other")]


def _outcome(fn):
    try:
        v = fn()
        return ("ok", v.tolist() if isinstance(v, np.ndarray) else (
            v.name if hasattr(v, "name") else v))
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return (type(exc).__name__, str(exc))


def test_inspect_matches_jax():
    jreg = JRegistry()
    e, f = _scene(jreg, np.random.default_rng(3))
    reg = from_reference(jreg)
    for ent in (e, f):
        assert inspect.list_entity(reg, ent) == \
            jinspect.list_entity(jreg, ent)
    for t in jc.ALL_COMPONENT_TYPES:
        name = t.__name__.removesuffix("Component")
        assert inspect.component_schema(name) == \
            jinspect.component_schema(name)
    assert [t.__name__ for t in C.ALL_COMPONENT_TYPES] == \
        [t.__name__ for t in jc.ALL_COMPONENT_TYPES]
    for comp, field, value in BAD_WRITES + GOOD_WRITES:
        got = _outcome(lambda: inspect.set_field(reg, e, comp, field, value))
        want = _outcome(lambda: jinspect.set_field(jreg, e, comp, field,
                                                   value))
        assert got == want, (comp, field, value)
    assert inspect.list_entity(reg, e) == jinspect.list_entity(jreg, e)
    assert reg.get(e, C.TextureComponent).dirty is True
    assert inspect.get_field(reg, e, "Light", "light_type") == \
        jinspect.get_field(jreg, e, "Light", "light_type")
    data = inspect.serialize_component(reg.get(e, C.TransformComponent))
    fresh = inspect.apply_component(C.TransformComponent(), data)
    assert inspect.serialize_component(fresh) == data


def test_alloc_tracker_host_and_cpu_device():
    tracker = alloc.AllocationTracker(track_host=True, device="cpu")
    tracker.begin_frame()
    _garbage = [bytearray(1000) for _ in range(100)]
    tracker.end_frame()
    s = tracker.stats()
    assert s.host_bytes > 0 and s.host_allocs > 0
    assert (s.device_bytes_in_use, s.device_peak_bytes) == (0, 0)
    assert alloc.device_memory_stats("cpu") == (0, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            alloc.device_memory_stats()          # the card, and there is none
