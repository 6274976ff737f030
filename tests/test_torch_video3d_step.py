"""The video3d train step and its checkpoints in the port against the JAX
package's, from the same parameters on the same batch (tests/test_video3d.py
sizes: nef=ngf=ndf=8, nBottleneck 32, video3dLevels 3, fineSize 32,
predLen 2, batch 2).

The JAX video3d step takes ``losses.weighted_mse`` (the Pallas gate refuses
5-D operands); the port's step takes the fused kernel's wrapper, whose CPU
path is the plain version.  JAX's gradients come from its step: optax's
first Adam update stores mu = (1 - beta1) * g, so g = mu / 0.5 exactly.

Tolerances (tests/test_torch_video_step.py): metrics rtol 1e-4; gradients
rtol 2e-3 / atol 2e-5; BN running statistics rtol 1e-3 / atol 1e-5;
parameters after one Adam step atol 4.1e-3; the 3-step loss trajectory
rtol 0.05; a checkpoint moves every leaf exactly.  Batches are zero-mean
(ROADMAP §C: the JAX BatchNorm's one-pass variance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.checkpoint import ckpt as jckpt
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.eval import common as jcommon
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.checkpoint import ckpt, convert
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.eval import common
from video_filler_tpu_torch.models import build_for_regime
from video_filler_tpu_torch.ops.cuda import fused_loss as fl
from video_filler_tpu_torch.train import step as tstep

torch.set_num_threads(1)

TINY = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, batchSize=2, fineSize=32,
            video3dLevels=3, predLen=2, wtl2=0.999, weight_nomask=0.05,
            computeDtype="float32")
# case -> (options over TINY, with_init)
CASES = {
    "video3d": ({}, False),
    "video3d_composite_wtgdl": (dict(weight_nomask=0.0, wtgdl=0.1), False),
    "video3d_withinit": (dict(weight_nomask=0.0), True),
}
N_STEPS = 3


def _batch(seed, n=2):
    """A zero-mean (B,T,32,32,3) clip and a (B,1,32,32,1) block mask."""
    rs = np.random.RandomState(seed)
    mask = np.zeros((n, 1, 32, 32, 1), np.float32)
    mask[:, :, 8:20, 6:26] = 1.0
    mask[1, :, 2:10, 20:30] = 1.0
    return {"real": rs.uniform(-1, 1, (n, 2, 32, 32, 3)).astype(np.float32),
            "mask": mask}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def cache():
    """The JAX init state (jitted: the eager init compiles each leaf's
    draw), jitted steps and one-step results, shared by this module."""
    jopt = JaxOpt(**TINY)
    init = jax.jit(lambda k: jstep.init_train_state(k, jopt, "video3d"))
    return {"state": init(jax.random.PRNGKey(0))}


def _jax_case(cache, case):
    """(jitted step, init_net or None) of a case."""
    key = ("jax", case)
    if key not in cache:
        kw, with_init = CASES[case]
        jopt = JaxOpt(**{**TINY, **kw})
        step = jax.jit(jstep.make_train_step(jopt, "video3d",
                                             with_init=with_init))
        init_net = None
        if with_init:
            # a generator other than the one trained: G's weights scaled
            st = cache["state"]
            init_net = (jax.tree.map(lambda x: 1.5 * x, st.params_g),
                        st.state_g)
        cache[key] = (step, init_net)
    return cache[key]


def _port(case, jax_state, init_net=None):
    kw, with_init = CASES[case]
    opt = Opt(device="cpu", **{**TINY, **kw})
    state = tstep.init_train_state(opt, "video3d",
                                   torch.Generator().manual_seed(0))
    sd_g, sd_d = convert.from_jax(jax_state.params_g, jax_state.state_g,
                                  jax_state.params_d, jax_state.state_d)
    state.gen.load_state_dict(sd_g, strict=True)
    state.disc.load_state_dict(sd_d, strict=True)
    tinit = None
    if with_init:
        tinit = build_for_regime(opt, "video3d")[0]
        tinit.load_state_dict(convert.tree_to_state_dict(*init_net))
    return state, tstep.make_train_step(opt, "video3d",
                                        with_init=with_init), tinit


def _jax_args(init_net, batch, i):
    args = (_jb(batch), jax.random.PRNGKey(100 + i))
    return args + ((init_net,) if init_net is not None else ())


def _allclose_trees(ours, ref, **tol):
    la, ta = jax.tree.flatten(ours)
    lb, tb = jax.tree.flatten(ref)
    assert ta == tb
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _one_step(cache, case):
    """Both sides after one step on the case's first batch."""
    key = ("one_step", case)
    if key not in cache:
        step, init_net = _jax_case(cache, case)
        batch = _batch(1)
        new_state, metrics = step(cache["state"],
                                  *_jax_args(init_net, batch, 0))
        pstate, pstep, tinit = _port(case, cache["state"], init_net)
        pmetrics = pstep(pstate, _tb(batch), tinit)
        cache[key] = (new_state, metrics, pstate, pmetrics)
    return cache[key]


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_metrics_match(cache, case):
    _, metrics, _, pmetrics = _one_step(cache, case)
    assert set(pmetrics) == set(tstep.METRIC_KEYS)
    for k in tstep.METRIC_KEYS:
        np.testing.assert_allclose(pmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert (pmetrics["errG_gdl"].item() > 0) == ("wtgdl" in case)


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_gradients_match(cache, case):
    new_state, _, pstate, _ = _one_step(cache, case)
    for module, opt_state in ((pstate.gen, new_state.opt_g),
                              (pstate.disc, new_state.opt_d)):
        ref = jax.tree.map(lambda m: np.asarray(m) / 0.5, opt_state[0].mu)
        grads = {n: p.grad for n, p in module.named_parameters()}
        _allclose_trees(convert.state_dict_to_tree(grads)[0], ref,
                        rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_params_and_bn_stats_after_one_step_match(cache, case):
    new_state, _, pstate, _ = _one_step(cache, case)
    for module, params, bn in ((pstate.gen, new_state.params_g,
                                new_state.state_g),
                               (pstate.disc, new_state.params_d,
                                new_state.state_d)):
        ours_p, ours_s = convert.state_dict_to_tree(module.state_dict())
        _allclose_trees(ours_p, params, atol=4.1e-3)
        _allclose_trees(ours_s, bn, rtol=1e-3, atol=1e-5)


def test_three_step_loss_trajectory_tracks(cache):
    step, _ = _jax_case(cache, "video3d")
    state = cache["state"]
    pstate, pstep, _ = _port("video3d", state)
    for i in range(N_STEPS):
        batch = _batch(10 + i)
        state, m = step(state, *_jax_args(None, batch, i))
        pm = pstep(pstate, _tb(batch))
        for k in ("errD", "errG_l2", "errG_total"):
            np.testing.assert_allclose(pm[k].item(), float(m[k]), rtol=0.05,
                                       err_msg=f"{k} step {i + 1}")
    assert pstate.step == N_STEPS


def test_reconstruction_term_gets_the_clip_operands(monkeypatch):
    """G's output, contiguous (B,T,H,W,C), the clip and the (B,1,H,W,1)
    weights reach the loss as they are; all plan to the 32-bit row path."""
    calls = []
    real_fn = tstep.fused_weighted_mse

    def recording(pred, target, weights):
        p = fl.plan(pred, target, weights)
        calls.append((tuple(pred.shape), pred.dtype, pred.is_contiguous(),
                      tuple(weights.shape), p.variant, p.index32))
        return real_fn(pred, target, weights)

    monkeypatch.setattr(tstep, "fused_weighted_mse", recording)
    for lam in (0.05, 0.0):
        opt = Opt(device="cpu", **{**TINY, "computeDtype": "bfloat16",
                                   "weight_nomask": lam})
        state = tstep.init_train_state(opt, "video3d",
                                       torch.Generator().manual_seed(2))
        tstep.make_train_step(opt, "video3d")(state, _tb(_batch(3)))
    clip, w = (2, 2, 32, 32, 3), (2, 1, 32, 32, 1)
    assert calls == [(clip, torch.bfloat16, True, w, "row", True),
                     (clip, torch.float32, True, w, "row", True)]  # composite


# --- checkpoints ------------------------------------------------------------

def test_jax_video3d_checkpoint_resumes_in_the_port(cache, tmp_path):
    new_state, _, _, _ = _one_step(cache, "video3d")
    step, _ = _jax_case(cache, "video3d")
    path = jckpt.save_checkpoint(str(tmp_path), "jx", 1, new_state,
                                 meta={"epoch": 1, "regime": "video3d"})
    jstate, _ = jckpt.restore_checkpoint(path, cache["state"])
    new_j, m_j = step(jstate, *_jax_args(None, _batch(2), 1))

    opt = Opt(device="cpu", **TINY)
    pstate = tstep.init_train_state(opt, "video3d",
                                    torch.Generator().manual_seed(9))
    assert ckpt.restore_checkpoint(path, pstate) == {"epoch": 1,
                                                     "regime": "video3d"}
    assert pstate.step == 1
    m_p = tstep.make_train_step(opt, "video3d")(pstate, _tb(_batch(2)))
    for k in tstep.METRIC_KEYS:
        np.testing.assert_allclose(m_p[k].item(), float(m_j[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    flat, ref = ckpt.flatten_state(pstate), jckpt._flatten(new_j)
    assert set(flat) == set(ref)
    for k, v in ref.items():
        assert flat[k].shape == v.shape, k
        if ".params_" in k:
            np.testing.assert_allclose(flat[k], v, atol=4.1e-3, err_msg=k)
        elif ".state_" in k:
            np.testing.assert_allclose(flat[k], v, rtol=1e-3, atol=1e-5,
                                       err_msg=k)
        elif k.endswith(".count") or k == ".step":
            assert int(flat[k]) == int(v) == 2, k


def test_port_video3d_checkpoint_restores_in_jax(cache, tmp_path):
    _, _, pstate, _ = _one_step(cache, "video3d")
    path = ckpt.save_checkpoint(str(tmp_path), "pt", 1, pstate,
                                meta={"epoch": 1})
    restored, meta = jckpt.restore_checkpoint(path, cache["state"])
    assert meta == {"epoch": 1} and int(restored.step) == 1
    for module, opt, params, bn, opt_state in (
            (pstate.gen, pstate.opt_g, restored.params_g, restored.state_g,
             restored.opt_g),
            (pstate.disc, pstate.opt_d, restored.params_d, restored.state_d,
             restored.opt_d)):
        ours_p, ours_s = convert.state_dict_to_tree(module.state_dict())
        nu, _ = convert.state_dict_to_tree(
            {n: opt.state[p]["exp_avg_sq"]
             for n, p in module.named_parameters()})
        for ours, ref in ((ours_p, params), (ours_s, bn),
                          (nu, opt_state[0].nu)):
            _allclose_trees(ours, ref, rtol=0, atol=0)
        assert int(opt_state[0].count) == 1


def test_keep_best_generator_file_reads_in_both_packages(cache, tmp_path):
    """The port's G-only file (keepBest) gives JAX's loader the port's
    forward, and a JAX checkpoint gives the port's loader JAX's."""
    _, _, pstate, _ = _one_step(cache, "video3d")
    best = ckpt.save_checkpoint(str(tmp_path), "kb", "best", pstate,
                                meta={"hole_l2": 0.5}, generator_only=True)
    with np.load(best) as f:
        assert not any(k.startswith((".params_d", ".opt_")) for k in f.files)
    new_state, _, _, _ = _one_step(cache, "video3d")
    full = jckpt.save_checkpoint(str(tmp_path), "jx", 1, new_state)
    jopt, popt = JaxOpt(**TINY), Opt(device="cpu", **TINY)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 2, 32, 32, 3)).astype(
        np.float32)
    for path in (best, full):
        fwd, params, bn = jcommon.load_generator(jopt, "video3d", path)
        gen = common.load_generator(popt, "video3d", path, "cpu")
        assert not gen.training
        with torch.inference_mode():
            got = gen(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(fwd(params, bn,
                                                       jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)


def test_bf16_video3d_parity_at_batch_8():
    """ROADMAP C.1, video3d (tests/test_torch_models.py
    ``check_bf16_parity`` for the three assertions and how each tolerance
    comes from the spreads).  Measured on the CPU at nef=ngf=ndf=8,
    nBottleneck 32, 3 levels, batch 8: G's bf16-vs-f32 error is 7.89e-4
    mean / 6.08e-3 max abs for JAX and 7.83e-4 / 7.02e-3 for the port; port
    against JAX in bf16 6.79e-4 / 5.86e-3.  One-step errD moves 2.8e-4
    (JAX) and 3.4e-4 (port) relative, the two bf16 values differ by
    5.4e-5; errG 2.3e-4 / 3.5e-4 against 1.2e-4; errG_l2 7.8e-7 / 3.5e-5
    against 3.5e-5."""
    from test_torch_models import bf16_spreads, check_bf16_parity
    check_bf16_parity(bf16_spreads("video3d", dict(TINY, batchSize=8),
                                   _batch(1, 8)))
