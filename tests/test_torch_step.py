"""The slice as a whole: the port's center train step against the JAX
package's fused step, from the same parameters on the same batch.

The batch is the JAX side's preprocess output, handed to the port.
Tolerances: metrics rtol 1e-4; gradients rtol 2e-3 / atol 2e-5 and BN
running statistics rtol 1e-3 / atol 1e-5 (tests/test_step_golden.py);
parameters after one Adam step atol 4.1e-3 (a first Adam step is about
lr*sign(g), so a tiny gradient that flips sign moves a weight by 2*lr_G,
tests/test_pallas.py); the 5-step loss trajectory rtol 0.05
(tests/test_step_golden.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.models import build_for_regime as jax_build
from video_filler_tpu.ops import losses as jlosses
from video_filler_tpu.ops import masks as jmasks
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.checkpoint import convert
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data.synthetic import _texture
from video_filler_tpu_torch.train import step as tstep

torch.set_num_threads(1)

SMALL = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=2, wtl2=0.999,
             overlapPred=4, computeDtype="float32")
N_STEPS = 5


@pytest.fixture(scope="module")
def jax_side():
    """JAX init state, its jitted step and preprocess, and N_STEPS
    preprocessed batches (numpy)."""
    jopt = JaxOpt(**SMALL)
    state = jstep.init_train_state(jax.random.PRNGKey(0), jopt, "center")
    step = jax.jit(jstep.make_train_step(jopt, "center"))
    pre = jax.jit(jstep.make_preprocess(jopt, "center"))
    # Smooth textures, as the synthetic image folders hold: on uniform
    # noise at batch 2, D is chaotic enough that one first-step Adam sign
    # flip moves errD by 7% at step 3.
    rs = np.random.RandomState(11)
    reals = []
    for i in range(N_STEPS):
        raw = np.stack([_texture(rs, 140, 150) for _ in range(2)])
        reals.append(np.array(pre({"raw": jnp.asarray(raw)},
                                    jax.random.PRNGKey(50 + i))["real"]))
    return jopt, state, step, reals


def _port_state(jax_state):
    opt = Opt(device="cpu", **SMALL)
    state = tstep.init_train_state(opt, "center",
                                   torch.Generator().manual_seed(0))
    sd_g, sd_d = convert.from_jax(jax_state.params_g, jax_state.state_g,
                                  jax_state.params_d, jax_state.state_d)
    state.gen.load_state_dict(sd_g, strict=True)
    state.disc.load_state_dict(sd_d, strict=True)
    return opt, state


def _port_tree(module):
    return convert.state_dict_to_tree(module.state_dict())


def _allclose_trees(ours, ref, **tol):
    la, ta = jax.tree.flatten(ours)
    lb, tb = jax.tree.flatten(ref)
    assert ta == tb
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.fixture(scope="module")
def one_step(jax_side):
    """Both sides after one step on the first batch."""
    _, state, step, reals = jax_side
    new_state, metrics = step(state, {"real": jnp.asarray(reals[0])},
                              jax.random.PRNGKey(100))
    opt, pstate = _port_state(state)
    pmetrics = tstep.make_train_step(opt, "center")(
        pstate, {"real": torch.from_numpy(reals[0])})
    return state, new_state, metrics, pstate, pmetrics


def test_one_step_metrics_match(one_step):
    _, _, metrics, _, pmetrics = one_step
    assert set(pmetrics) == set(tstep.METRIC_KEYS)
    for k in tstep.METRIC_KEYS:
        np.testing.assert_allclose(pmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_one_step_gradients_match(jax_side, one_step):
    """Each net's gradient: the JAX step's loss (train/step.py loss_fn,
    center regime) differentiated by jax.grad, against .grad after the
    port's step -- D gets only loss_d, G only loss_g."""
    jopt, _, _, reals = jax_side
    state, _, _, pstate, _ = one_step
    gen, disc = jax_build(jopt, "center")
    real = jnp.asarray(reals[0])
    target = jmasks.extract_center(real)
    ctx = jmasks.center_mask_fill(real, 4)
    w = jlosses.overlap_l2_weights((64, 64), 4, 0.999)[None]

    def loss_fn(gp, dp):
        fake, _ = gen.apply(gp, state.state_g, ctx, train=True)
        lr_, sd1 = disc.apply(dp, state.state_d, target, train=True)
        lf, _ = disc.apply(dp, sd1, jax.lax.stop_gradient(fake), train=True)
        loss_d = (jlosses.bce_with_logits(lr_, 1.0)
                  + jlosses.bce_with_logits(lf, 0.0))
        lg, _ = disc.apply(jax.lax.stop_gradient(dp), sd1, fake, train=True)
        loss_g = (0.001 * jlosses.bce_with_logits(lg, 1.0)
                  + jlosses.weighted_mse(fake, target, w))
        return loss_g + loss_d

    grad_g, grad_d = jax.grad(loss_fn, argnums=(0, 1))(state.params_g,
                                                       state.params_d)
    for module, ref in ((pstate.gen, grad_g), (pstate.disc, grad_d)):
        grads = {n: p.grad for n, p in module.named_parameters()}
        ours, _ = convert.state_dict_to_tree(grads)
        _allclose_trees(ours, ref, rtol=2e-3, atol=2e-5)


def test_params_after_one_adam_step_match(one_step):
    _, new_state, _, pstate, _ = one_step
    _allclose_trees(_port_tree(pstate.gen)[0], new_state.params_g, atol=4.1e-3)
    _allclose_trees(_port_tree(pstate.disc)[0], new_state.params_d,
                    atol=4.1e-3)


def test_bn_running_stats_updated_twice_for_d_once_for_g(jax_side, one_step):
    jopt, _, _, reals = jax_side
    state, new_state, _, pstate, _ = one_step
    tol = dict(rtol=1e-3, atol=1e-5)
    _allclose_trees(_port_tree(pstate.gen)[1], new_state.state_g, **tol)
    _allclose_trees(_port_tree(pstate.disc)[1], new_state.state_d, **tol)
    # D's statistics are not those of the real pass alone: the fake pass
    # updated them a second time (and the G-adversarial pass did not).
    _, disc = jax_build(jopt, "center")
    _, sd1 = disc.apply(state.params_d, state.state_d,
                        jmasks.extract_center(jnp.asarray(reals[0])),
                        train=True)
    ours = _port_tree(pstate.disc)[1]
    assert not np.allclose(ours["bn2"]["mean"], np.asarray(sd1["bn2"]["mean"]),
                           rtol=1e-3, atol=1e-5)


def test_five_step_loss_trajectory_tracks(jax_side):
    _, state, step, reals = jax_side
    opt, pstate = _port_state(state)
    pstep = tstep.make_train_step(opt, "center")
    for i in range(N_STEPS):
        state, m = step(state, {"real": jnp.asarray(reals[i])},
                        jax.random.PRNGKey(100 + i))
        pm = pstep(pstate, {"real": torch.from_numpy(reals[i])})
        np.testing.assert_allclose(pm["errD"].item(), float(m["errD"]),
                                   rtol=0.05, err_msg=f"errD step {i + 1}")
        np.testing.assert_allclose(pm["errG_l2"].item(), float(m["errG_l2"]),
                                   rtol=0.05, err_msg=f"errG_l2 step {i + 1}")
    assert pstate.step == N_STEPS


def test_preprocess_matches_jax_with_its_decisions():
    jopt = JaxOpt(**SMALL)
    raw = np.random.RandomState(12).randint(0, 256, (3, 140, 150, 3),
                                            np.uint8)
    key = jax.random.PRNGKey(21)
    ref = jstep.make_preprocess(jopt, "center")({"raw": jnp.asarray(raw)},
                                                key)["real"]
    k_crop, k_flip = jax.random.split(key)
    ky, kx = jax.random.split(k_crop)
    draws = {
        "y0": torch.from_numpy(np.asarray(
            jax.random.randint(ky, (3,), 0, 140 - 128))),
        "x0": torch.from_numpy(np.asarray(
            jax.random.randint(kx, (3,), 0, 150 - 128))),
        "flip": torch.from_numpy(np.asarray(
            jax.random.uniform(k_flip, (3,)) < 0.5)),
    }
    pre = tstep.make_preprocess(Opt(device="cpu", **SMALL), "center")
    ours = pre({"raw": torch.from_numpy(raw)}, draws=draws)["real"]
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_preprocess_draws_from_the_generator():
    pre = tstep.make_preprocess(Opt(device="cpu", **SMALL), "center")
    raw = torch.from_numpy(np.random.RandomState(13).randint(
        0, 256, (4, 128, 128, 3), np.uint8))
    a = pre({"raw": raw}, torch.Generator().manual_seed(1))["real"]
    b = pre({"raw": raw}, torch.Generator().manual_seed(1))["real"]
    assert a.shape == (4, 128, 128, 3) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.min()) >= -1.0 and float(a.max()) <= 1.0


def test_reconstruction_term_goes_through_the_fused_loss(monkeypatch):
    calls = []
    real_fn = tstep.fused_weighted_mse

    def counting(pred, target, weights):
        calls.append((tuple(pred.shape), tuple(weights.shape)))
        return real_fn(pred, target, weights)

    monkeypatch.setattr(tstep, "fused_weighted_mse", counting)
    opt = Opt(device="cpu", **SMALL)
    state = tstep.init_train_state(opt, "center",
                                   torch.Generator().manual_seed(2))
    real = torch.rand(2, 128, 128, 3) * 2 - 1
    tstep.make_train_step(opt, "center")(state, {"real": real})
    assert calls == [((2, 64, 64, 3), (1, 64, 64, 1))]


@pytest.mark.parametrize("wtl2,g_over_d", [(0.999, 10.0), (0.0, 1.0),
                                           (1.0, 1.0)])
def test_g_learning_rate_is_10x_when_wtl2_in_0_1(wtl2, g_over_d):
    opt = Opt(device="cpu", **dict(SMALL, wtl2=wtl2))
    state = tstep.init_train_state(opt, "center",
                                   torch.Generator().manual_seed(3))
    lr_g = state.opt_g.param_groups[0]["lr"]
    lr_d = state.opt_d.param_groups[0]["lr"]
    assert lr_g == pytest.approx(g_over_d * lr_d)
    assert state.opt_g.param_groups[0]["betas"] == (opt.beta1, 0.999)
    assert state.opt_g.param_groups[0]["eps"] == 1e-8


@pytest.mark.parametrize("kw", [
    {"gradAccum": 2}, {"remat": 1}, {"adamMomentsBf16": True},
    {"conditionAdv": True}, {"noiseGen": True, "nz": 5},
], ids=["gradAccum", "remat", "adamMomentsBf16", "conditionAdv", "noiseGen"])
def test_step_options_match_the_jax_center_step(jax_side, kw):
    """The options the port once refused, each one center step against the
    JAX step from the same init (its own, for the options that change G, D
    or the Adam state) on the same batch: gradAccum on the two batches joined (microbatches
    of 2), noiseGen with the JAX step's z.  Metrics rtol 1e-4."""
    jopt, state, _, reals = jax_side
    jopt = jopt.replace(**kw)
    real = np.concatenate(reals[:2]) if "gradAccum" in kw else reals[0]
    jopt = jopt.replace(batchSize=real.shape[0])
    if {"conditionAdv", "noiseGen", "adamMomentsBf16"} & set(kw):
        state = jax.jit(lambda k: jstep.init_train_state(k, jopt, "center"))(
            jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(100)
    _, metrics = jax.jit(jstep.make_train_step(jopt, "center"))(
        state, {"real": jnp.asarray(real)}, key)
    opt = Opt(device="cpu", **{**SMALL, **kw, "batchSize": real.shape[0]})
    pstate = tstep.init_train_state(opt, "center",
                                    torch.Generator().manual_seed(0))
    sd_g, sd_d = convert.from_jax(state.params_g, state.state_g,
                                  state.params_d, state.state_d)
    pstate.gen.load_state_dict(sd_g, strict=True)
    pstate.disc.load_state_dict(sd_d, strict=True)
    noise = None
    if "noiseGen" in kw:
        noise = torch.from_numpy(np.array(jstep._draw_noise(
            jax.random.split(key)[0], jopt, real.shape[0])))
    pmetrics = tstep.make_train_step(opt, "center")(
        pstate, {"real": torch.from_numpy(real)}, noise=noise)
    for k in tstep.METRIC_KEYS:
        np.testing.assert_allclose(pmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kw", [{"wtgdl": 0.1},
                                {"wtgdl": 0.1, "gdlTorchQuirk": True}],
                         ids=["wtgdl", "gdl_quirk"])
def test_gdl_options_run_on_the_center_step(jax_side, kw):
    """The GDL term on the center regime, against the JAX step."""
    jopt, state, _, reals = jax_side
    jopt = jopt.replace(**kw)
    _, metrics = jax.jit(jstep.make_train_step(jopt, "center"))(
        state, {"real": jnp.asarray(reals[0])}, jax.random.PRNGKey(100))
    opt, pstate = _port_state(state)
    pmetrics = tstep.make_train_step(opt.replace(**kw), "center")(
        pstate, {"real": torch.from_numpy(reals[0])})
    assert pmetrics["errG_gdl"].item() > 0
    for k in tstep.METRIC_KEYS:
        np.testing.assert_allclose(pmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
