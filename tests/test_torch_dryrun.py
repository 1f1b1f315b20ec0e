"""The multi-device training steps of parallel/dryrun.py and the mesh of
parallel/mesh.py on trident_tpu_torch against the JAX package, on the CPU.

One process group for the whole file: the module fixture starts four CPU
ranks under gloo once and runs three jobs in them, all from one JAX init
carried across and one batch: the dp×tp step at dp 2 × tp 2, the same
step at dp 4 × tp 1, and the explicit-collective step at dp = 4 (the
batch tiled to four samples). Each loss is within 1e-4 of the JAX
single-device train_step on that batch and of the others (the JAX dry
run's check); each step's gradients (the dp×tp ones reassembled from
their shards) within rtol 1e-3 / atol 1e-6 of the JAX step's, and its
running stats within 1e-6; synced stats are equal on every rank that
holds them.

The gradients and stats are held against the JAX step in float64 (the
JAX net with dtype float64 under jax.enable_x64, on the same f32 values
widened): at 32² the float32 JAX step's rounding moves single gradient
values past rtol 1e-3 of the float64 step, where the port's float32
gradients stay within it. The loss is held against the float32 JAX step
as well.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from trident_tpu.ai import train as jtrain
from trident_tpu.ai.model import init_model as jinit_model
from trident_tpu.parallel import mesh as jmesh

from trident_tpu_torch.ai.model import (
    InterpolationUNet,
    params_from_flax,
    params_to_flax,
)
from trident_tpu_torch.parallel import dryrun, mesh

torch.set_num_threads(1)

RES = (32, 32)
BASE = 8
LR = 2e-4
LOSS_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
STATS_TOL = 1e-6
N = 4


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if hasattr(tree[k], "items"):
            out.update(_leaves(dict(tree[k]), f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(tree[k])
    return out


@pytest.fixture(scope="module")
def runs():
    """(JAX loss, grads, new stats; the three jobs' per-rank results)."""
    model, variables = jinit_model(jax.random.PRNGKey(0), RES, BASE)
    rng = np.random.default_rng(0)
    x = rng.random((2, *RES, 6), np.float32)
    y = rng.random((2, *RES, 3), np.float32)
    state = jtrain.TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=optax.adam(LR))

    def loss_fn(params):
        out, mutated = model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jtrain.l1_loss(out, jnp.asarray(y)), mutated["batch_stats"]

    jloss = jax.jit(loss_fn)(state.params)[0]
    with jax.enable_x64(True):
        wide = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)

        def loss64(params):
            out, mutated = model.clone(dtype=jnp.float64).apply(
                {"params": params, "batch_stats": wide(state.batch_stats)},
                jnp.asarray(x, jnp.float64), train=True,
                mutable=["batch_stats"])
            return (jnp.mean(jnp.abs(out - jnp.asarray(y, jnp.float64))),
                    mutated["batch_stats"])

        (loss_64, jstats), jgrads = jax.value_and_grad(
            loss64, has_aux=True)(wide(state.params))
        jstats, jgrads = (jax.tree.map(lambda a: np.asarray(a, np.float32), t)
                          for t in (jstats, jgrads))
    assert abs(float(loss_64) - float(jloss)) < LOSS_TOL
    init = {k: v.numpy() for k, v in params_from_flax(
        variables["params"], variables["batch_stats"]).items()}
    jobs = dryrun.dryrun_jobs(init, x, y, BASE, N, 2, LR)
    x4, y4 = dryrun.tile_batch(x, y, N)
    jobs.append(dict(jobs[0], tp=1, inputs=x4, targets=y4))
    results = dryrun.run_jobs(["cpu"] * N, jobs)
    return (float(jloss), _leaves(jgrads), _leaves(jstats)), results


def _assembled(ranks, key):
    """The dp row 0 ranks' `key` dicts joined over tp along each shard's
    dimension, in the flax layout (params, batch_stats)."""
    row = [r for r in ranks if r["coords"]["dp"] == 0]
    row.sort(key=lambda r: r["coords"]["tp"])
    full = {}
    for name in row[0][key]:
        parts = [torch.from_numpy(r[key][name]) for r in row]
        dims = row[0]["dims"][name]
        full[name] = torch.cat(parts, dims["tp"]) if dims else parts[0]
    net = InterpolationUNet(base_channels=BASE)
    net.load_state_dict({**net.state_dict(), **full})
    params, stats = params_to_flax(net)
    return _leaves(params) if key == "grads" else _leaves(stats)


def test_losses_match_the_jax_step_and_each_other(runs):
    (jloss, _g, _s), (dp_tp, explicit, dp4) = runs
    losses = [dp_tp[0]["loss"], explicit[0]["loss"], dp4[0]["loss"]]
    for r in dp_tp + explicit + dp4:
        assert np.isfinite(r["loss"])
    for loss in losses:
        assert abs(loss - jloss) < LOSS_TOL
        assert all(abs(loss - other) < LOSS_TOL for other in losses)
    assert [r["mesh"] for r in dp_tp[:1] + dp4[:1]] == [
        {"dp": 2, "tp": 2}, {"dp": 4, "tp": 1}]
    assert {r["out_shape"] for r in dp_tp} == {(1, 3, *RES)}
    assert {r["out_shape"] for r in explicit} == {(1, 3, *RES)}


@pytest.mark.parametrize("job", [0, 2], ids=["dp2xtp2", "dp4xtp1"])
def test_dp_tp_grads_and_stats_match_jax(runs, job):
    (_l, jgrads, jstats), results = runs
    ranks = results[job]
    got = _assembled(ranks, "grads")
    assert got.keys() == jgrads.keys()
    for k, v in jgrads.items():
        np.testing.assert_allclose(got[k], v, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
    stats = _assembled(ranks, "stats")
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k], v, rtol=0, atol=STATS_TOL,
                                   err_msg=k)
    # ranks that hold the same shard of a stat hold the same values
    for r in ranks:
        twin = next(q for q in ranks
                    if q["coords"]["tp"] == r["coords"]["tp"])
        for k, v in r["stats"].items():
            np.testing.assert_array_equal(v, twin["stats"][k], err_msg=k)


def test_explicit_step_syncs_stats_and_grads(runs):
    (_l, jgrads, jstats), (_dp_tp, explicit, _dp4) = runs
    for r in explicit[1:]:
        for key in ("stats", "grads"):
            for k, v in r[key].items():
                np.testing.assert_array_equal(v, explicit[0][key][k],
                                              err_msg=k)
    net = InterpolationUNet(base_channels=BASE)
    net.load_state_dict({**net.state_dict(), **{
        k: torch.from_numpy(v) for k, v in
        {**explicit[0]["grads"], **explicit[0]["stats"]}.items()}})
    params, stats = params_to_flax(net)
    for k, v in jgrads.items():
        np.testing.assert_allclose(_leaves(params)[k], v, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    for k, v in jstats.items():
        np.testing.assert_allclose(_leaves(stats)[k], v, rtol=0,
                                   atol=STATS_TOL, err_msg=k)


def test_check_dryrun_prints_the_jax_lines(runs, capsys):
    _j, (dp_tp, explicit, _dp4) = runs
    dryrun.check_dryrun(dp_tp, explicit, (2, *RES, 3))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(
        "dryrun_multichip OK: mesh={'dp': 2, 'tp': 2} loss=")
    assert lines[0].endswith("out=(2, 32, 32, 3)")
    assert lines[1].startswith("dryrun explicit collectives OK: dp=4 loss=")
    bad = [dict(r, loss=r["loss"] + 1e-3) for r in explicit]
    with pytest.raises(RuntimeError, match="explicit-collective loss"):
        dryrun.check_dryrun(dp_tp, bad, (2, *RES, 3))


@pytest.mark.parametrize("n,tp", [(8, None), (4, 2), (6, None), (3, None),
                                  (4, 1)])
def test_mesh_and_param_sharding_follow_the_jax_rule(n, tp):
    """make_mesh's (dp, tp) shape and, for every parameter and running
    stat, whether param_sharding splits it, against the JAX rule on the
    JAX variables (the last axis there, the output-channel dim here)."""
    jm = jmesh.make_mesh(n, tp, devices=jax.devices()[:n])
    pm = mesh.make_mesh(n, tp, devices=["cpu"] * n)
    assert pm.shape == dict(jm.shape)
    _model, variables = jinit_model(jax.random.PRNGKey(0), RES, BASE)
    jspec = {**_leaves(jax.tree.map(
        lambda s: bool(s.spec) and s.spec[-1] == "tp",
        jmesh.param_sharding(jm, variables["params"]))),
        **_leaves(jax.tree.map(
            lambda s: bool(s.spec) and s.spec[-1] == "tp",
            jmesh.param_sharding(jm, variables["batch_stats"])))}
    net = InterpolationUNet(base_channels=BASE)
    specs = mesh.param_sharding(pm, net)
    flags = InterpolationUNet(base_channels=BASE)
    flags.load_state_dict({k: torch.full_like(v, float(bool(specs[k].dims)))
                           for k, v in net.state_dict().items()})
    params, stats = params_to_flax(flags)
    got = {**_leaves(params), **_leaves(stats)}
    assert got.keys() == jspec.keys()
    for k, v in jspec.items():
        assert bool(got[k].all()) == bool(v), k
    rows = mesh.batch_sharding(pm, 4).local(torch.arange(2 * pm.shape["dp"]),
                                            pm, n - 1)
    assert rows.tolist() == [2 * (pm.shape["dp"] - 1),
                             2 * (pm.shape["dp"] - 1) + 1]


def test_banded_render_lines(capsys):
    """dryrun_banded_render over four CPU bands (the JAX dry run's render
    phase): its three lines."""
    dryrun.dryrun_banded_render(["cpu"] * 4)
    out = capsys.readouterr().out
    assert "dryrun banded render OK: 4 bands (pallas+shadows)" in out
    assert "dryrun bundled banded OK: 4 bands, 2-blob uploads" in out
    assert "dryrun banded ai_upscale OK: 64->128 over 2 bands" in out
