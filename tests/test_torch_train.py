"""The interpolation net's training path on trident_tpu_torch against the
JAX package, on the CPU: ai/train.py (train_step, Adam, train(), the
checkpoints), ai/validate.py, FrameGenerator on a checkpoint directory,
models/__init__.py and scripts/train_frame_generator.py.

Every parity test starts the port from a JAX init carried across
(ai/model.py::params_from_flax) and compares in the JAX layout
(params_to_flax). Tolerances: one step's loss within 1e-5 relative, its
gradients within rtol 1e-3 / atol 1e-6 and the running stats within
1e-6 (both packages run f32 convs through their libraries, which may sum
in different orders); three steps' losses within 1e-4; the port's Adam
against optax.adam fed the same gradients within 1e-7 absolute and
relative (one f32 ulp at |p| ≈ 1). Adam's first
update moves a parameter by about ±lr·sign(g), so where g ≈ 0 a rounding
can flip it: the step is held by its gradients, not its updated params.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from trident_tpu.ai import train as jtrain
from trident_tpu.ai.model import init_model as jinit_model
from trident_tpu.io.image import save_png as jsave_png

from trident_tpu_torch import models
from trident_tpu_torch.ai import train as ptrain
from trident_tpu_torch.ai.frame_generator import FrameGenerator
from trident_tpu_torch.ai.model import (
    BN_MOMENTUM,
    InterpolationUNet,
    init_model,
    params_from_flax,
    params_to_flax,
)
from trident_tpu_torch.ai.validate import validate_checkpoint
from trident_tpu_torch.io.image import save_png

torch.set_num_threads(1)

RES = (16, 16)
BASE = 8
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
STATS_TOL = 1e-6
STEPS_TOL = 1e-4
ADAM_TOL = 1e-7


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if hasattr(tree[k], "items"):
            out.update(_leaves(dict(tree[k]), f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(tree[k])
    return out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2) \
        .contiguous()


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return (rng.random((n, *RES, 6), np.float32),
            rng.random((n, *RES, 3), np.float32))


@pytest.fixture(scope="module")
def jax_init():
    model, variables = jinit_model(jax.random.PRNGKey(3), RES, BASE)
    return model, variables


def _jax_state(jax_init):
    model, variables = jax_init
    return jtrain.TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=optax.adam(LR))


def _port_state(jax_init):
    _model, variables = jax_init
    net = InterpolationUNet(base_channels=BASE)
    net.load_state_dict(params_from_flax(variables["params"],
                                         variables["batch_stats"]))
    return ptrain.TrainState(net, ptrain.make_optimizer(net.parameters(), LR))


def _grads_flax(net):
    """The port's parameter gradients in the flax layout."""
    g = InterpolationUNet(base_channels=BASE)
    g.load_state_dict({**net.state_dict(),
                       **{n: p.grad for n, p in net.named_parameters()}})
    return _leaves(params_to_flax(g)[0])


def test_train_step_matches_jax(jax_init):
    """One step from the same init on one batch: loss, every gradient and
    the updated running stats against the JAX step's."""
    x, y = _batch(0)
    jstate = _jax_state(jax_init)

    def loss_fn(params):
        out, mutated = jstate.apply_fn(
            {"params": params, "batch_stats": jstate.batch_stats},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jtrain.l1_loss(out, jnp.asarray(y)), mutated["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jstate.params)
    _new, jloss2, _out = jax.jit(jtrain.train_step)(jstate, jnp.asarray(x),
                                                    jnp.asarray(y))
    assert float(jloss2) == float(jloss)

    state = _port_state(jax_init)
    state, loss, out = ptrain.train_step(state, _nchw(x), _nchw(y))
    assert out.shape == (2, 3, *RES) and state.step == 1
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * float(jloss)
    got, want = _grads_flax(state.model), _leaves(jgrads)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    got_stats = _leaves(params_to_flax(state.model)[1])
    for k, v in _leaves(jstats).items():
        np.testing.assert_allclose(got_stats[k], v, rtol=0, atol=STATS_TOL,
                                   err_msg=k)


def test_three_steps_match_jax(jax_init):
    jstate = _jax_state(jax_init)
    state = _port_state(jax_init)
    step = jax.jit(jtrain.train_step)
    for k in range(3):
        x, y = _batch(10 + k)
        jstate, jloss, _ = step(jstate, jnp.asarray(x), jnp.asarray(y))
        state, loss, _ = ptrain.train_step(state, _nchw(x), _nchw(y))
        assert abs(float(loss) - float(jloss)) <= STEPS_TOL, k


def test_adam_matches_optax_on_the_same_grads():
    """Four updates of init_model's params (lecun-normal kernels, BatchNorm
    scales 1) fed the same gradients, within 1e-7 absolute and relative:
    torch's Adam and optax.adam round their updates in different orders,
    which can move p + update by one f32 ulp (1.19e-7 at |p| ≈ 1)."""
    net = init_model(torch.Generator().manual_seed(5), RES, BASE,
                     device="cpu")
    params = [p.detach().numpy().copy() for p in net.parameters()]
    rng = np.random.default_rng(7)
    tx = optax.adam(LR)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = ptrain.make_optimizer(tp, LR)
    for _ in range(4):
        grads = [rng.normal(0, 1e-2, p.shape).astype(np.float32)
                 for p in params]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads],
                                       opt_state)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=ADAM_TOL, atol=ADAM_TOL)


def test_batchnorm_follows_flax_momentum_and_biased_variance():
    net = init_model(torch.Generator().manual_seed(0), RES, 4, device="cpu")
    bn = net.blocks[0].bn0
    x = torch.randn(3, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    before_m, before_v = bn.running_mean.clone(), bn.running_var.clone()
    net.train()
    bn(x)
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(
        bn.running_mean, BN_MOMENTUM * before_m + (1 - BN_MOMENTUM) * mean)
    torch.testing.assert_close(
        bn.running_var, BN_MOMENTUM * before_v + (1 - BN_MOMENTUM) * var)


def test_init_model_draws_lecun_normal_like_flax():
    """The distribution, not the values: every kernel's variance within
    15% of flax's for the same shape, bounded by ±2 σ of the truncated
    draw; biases and BatchNorm shifts 0, scales 1."""
    net = init_model(torch.Generator().manual_seed(0), (32, 32), 16,
                     device="cpu")
    _m, variables = jinit_model(jax.random.PRNGKey(0), (32, 32), 16)
    got, want = _leaves(params_to_flax(net)[0]), _leaves(variables["params"])
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith("kernel"):
            fan_in = int(np.prod(w.shape[:-1]))
            assert abs(g.var() / w.var() - 1) < 0.15, k
            assert np.abs(g).max() <= 2 / np.sqrt(fan_in) / 0.8796 + 1e-6, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    stats = params_to_flax(net)[1]
    assert _leaves(stats).keys() == _leaves(variables["batch_stats"]).keys()
    for k, v in _leaves(variables["batch_stats"]).items():
        np.testing.assert_array_equal(_leaves(stats)[k], v, err_msg=k)
    with pytest.raises(ValueError):
        init_model(torch.Generator(), (30, 32), 8, device="cpu")


def _frames(directory, n=8, size=16, writer=save_png):
    """The JAX test's drifting frames (tests/test_ai.py::make_frames)."""
    rng = np.random.default_rng(0)
    base = rng.random((size, size, 3)).astype(np.float32)
    for i in range(n):
        writer(str(directory / f"frame_{i:04d}.png"), np.roll(base, i, 1))
    return str(directory)


def test_train_runs_checkpoints_and_keeps_best_latest(tmp_path):
    (tmp_path / "frames").mkdir()
    src = _frames(tmp_path / "frames")
    log = tmp_path / "log.jsonl"
    cfg = ptrain.TrainConfig(source=src, resolution=RES, base_channels=4,
                             batch_size=2, epochs=3, val_fraction=0.3,
                             checkpoint_dir=str(tmp_path / "ckpt"),
                             checkpoint_every=1, learning_rate=1e-3,
                             log_path=str(log))
    summary = ptrain.train(cfg, device="cpu")
    assert summary["epochs_run"] == 3 and summary["best_psnr"] > 0
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(set(r) == {"epoch", "train_l1", "val_l1", "val_psnr",
                          "val_ssim", "seconds"} for r in records)
    # every epoch left a resume snapshot; latest.json names the best one
    for e in range(3):
        assert (tmp_path / "ckpt" / f"step_{e:06d}" /
                ptrain.CHECKPOINT_FILE).is_file()
    best = max(records, key=lambda r: r["val_psnr"])["epoch"]
    latest = json.loads((tmp_path / "ckpt" / "latest.json").read_text())
    assert latest == {"step": best, "path": f"step_{best:06d}",
                      "base_channels": 4}
    assert summary["checkpoint"].endswith(f"step_{best:06d}")
    net = ptrain.load_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    assert not net.training and net.base_channels == 4
    with torch.no_grad():
        assert net(torch.zeros(1, 6, *RES)).shape == (1, 3, *RES)


def test_periodic_checkpoint_keeps_best_latest(tmp_path):
    """The mirror of tests/test_ai.py::test_periodic_checkpoint_keeps_
    best_latest: a snapshot with update_latest=False does not retarget
    latest.json."""
    state = ptrain.create_state(ptrain.TrainConfig(resolution=(32, 32),
                                                   base_channels=8),
                                device="cpu")
    best = ptrain.save_checkpoint(state, str(tmp_path), 3)
    ptrain.save_checkpoint(state, str(tmp_path), 7, update_latest=False)
    latest = json.loads((tmp_path / "latest.json").read_text())
    assert latest["step"] == 3
    assert latest["path"] == "step_000003"
    assert best.endswith("step_000003")
    restored = ptrain.load_checkpoint(str(tmp_path), device="cpu")
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.state_dict()[k], v), k


def test_validate_checkpoint_ok_and_fails(tmp_path, capsys):
    from trident_tpu_torch.ai import validate

    state = ptrain.create_state(ptrain.TrainConfig(base_channels=8),
                                device="cpu")
    ptrain.save_checkpoint(state, str(tmp_path / "ok"), 0)
    res = validate_checkpoint(str(tmp_path / "ok"), (32, 32), 8,
                              device="cpu")
    assert res.ok, res.message
    assert validate.main([str(tmp_path / "ok"), "--resolution", "32",
                          "--base-channels", "8", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("OK: ")

    missing = validate_checkpoint(str(tmp_path / "nope"), device="cpu")
    assert not missing.ok and "checkpoint dir not found" in missing.message
    (tmp_path / "empty").mkdir()
    empty = validate_checkpoint(str(tmp_path / "empty"), device="cpu")
    assert not empty.ok and "no latest.json" in empty.message
    wide = validate_checkpoint(str(tmp_path / "ok"), (32, 32), 16,
                               device="cpu")
    assert not wide.ok and wide.message == (
        "architecture mismatch: checkpoint is 8-wide, expected "
        "base_channels=16")
    assert validate.main([str(tmp_path / "nope"), "--device", "cpu"]) == 1
    assert capsys.readouterr().out.startswith("FAIL: ")


def test_frame_generator_initialises_from_a_checkpoint_dir(tmp_path):
    state = ptrain.create_state(ptrain.TrainConfig(base_channels=4),
                                device="cpu")
    ptrain.save_checkpoint(state, str(tmp_path), 2)
    gen = FrameGenerator(resolution=(16, 16), device="cpu")
    assert gen.initialise(str(tmp_path))
    try:
        for k in range(2):
            gen.process_frame(np.full((16, 16, 3), k / 2, np.float32))
        for _ in range(200):
            got = gen.try_consume_output()
            if got is not None:
                break
            time.sleep(0.01)
        assert got is not None and got[1].shape == (16, 16, 3)
    finally:
        gen.shutdown()
    (tmp_path / "junk").mkdir()
    with pytest.raises(ValueError):
        FrameGenerator(device="cpu").initialise(str(tmp_path / "junk"))


def test_train_frame_generator_cli(tmp_path, capsys):
    from trident_tpu_torch.scripts import train_frame_generator as cli

    (tmp_path / "frames").mkdir()
    src = _frames(tmp_path / "frames", n=5, writer=jsave_png)
    ck = str(tmp_path / "ck")
    assert cli.main(["--source", src, "--resolution", "16",
                     "--base-channels", "4", "--batch-size", "2",
                     "--epochs", "1", "--checkpoint-dir", ck,
                     "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["epochs_run"] == 1 and os.path.isdir(summary["checkpoint"])
    assert cli.main(["--skip-training", "--base-channels", "4",
                     "--checkpoint-dir", str(tmp_path / "ci"),
                     "--device", "cpu"]) == 0
    assert validate_checkpoint(str(tmp_path / "ci"), (16, 16), 4,
                               device="cpu").ok


def test_models_reexports_the_jax_names():
    from trident_tpu import models as jmodels

    assert models.__all__ == jmodels.__all__
    assert models.train is ptrain.train
    assert models.validate_checkpoint is validate_checkpoint
