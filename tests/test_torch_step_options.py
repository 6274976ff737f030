"""The JAX package's other step options in the port: conditionAdv, noiseGen,
gradAccum, remat, adamMomentsBf16 and useBias, each against the JAX step
from the same parameters on the same batch with the JAX side's draws, then
the port's own mirrors of tests/test_train_step.py:248-395, checkpoints
both ways, and noiseGen through evaluate and the server.

JAX's gradients come from its step: the first Adam update stores
mu = (1 - beta1) * g, so g = mu / 0.5 (bf16 moments: g rounded to bf16).

Tolerances (tests/test_torch_step.py): metrics rtol 1e-4 / atol 1e-7;
gradients rtol 2e-3 / atol 2e-5; parameters after one Adam step atol
4.1e-3; BN running statistics rtol 1e-3 / atol 1e-5; 3-step trajectories
rtol 0.05.  bf16 moments: the bf16 roundings of two gradients within the
gradient tolerance, so one bf16 ulp (at most 2^-7 of the value) more.  A
checkpoint moves every leaf exactly.  uint8 outputs within one level.
"""

import io
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.checkpoint import ckpt as jckpt
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.eval import metrics as jmetrics
from video_filler_tpu.models import build_for_regime as jax_build
from video_filler_tpu.serve import InpaintServer as JaxServer
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.checkpoint import ckpt, convert
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import synthetic
from video_filler_tpu_torch.eval import common, metrics
from video_filler_tpu_torch.serve import InpaintServer
from video_filler_tpu_torch.train import loop
from video_filler_tpu_torch.train import step as tstep
from video_filler_tpu_torch.train.optim import AdamBf16Moments

torch.set_num_threads(1)

BASE = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, wtl2=0.999,
            computeDtype="float32")
REGIME = {"center": dict(overlapPred=4),
          "video": dict(predLen=2, weight_nomask=0.05),
          "video3d": dict(predLen=2, weight_nomask=0.05, fineSize=32,
                          video3dLevels=3)}
# case -> (regime, options, batch size, batch seed).  Each batch is one on
# which neither package's f32 step meets a discrete near-tie: on the video
# step at batch 4 from seed 1, the port's D conv0 gradient is 1.5e-2 off a
# float64 step of the port and JAX's 1.5e-5; at batch 8 it is the other way
# round (JAX 4.2e-4 off, the port 1.2e-5).  Two f32 results then differ by
# more than the gradient tolerance although both are right.
CASES = {
    "conditionAdv": ("center", dict(conditionAdv=True), 2, 1),
    "noiseGen": ("center", dict(noiseGen=True, nz=5), 2, 1),
    "noiseGen_uniform": ("center", dict(noiseGen=True, nz=5,
                                        noisetype="uniform"), 2, 1),
    "gradAccum": ("center", dict(gradAccum=2), 8, 1),
    "gradAccum_video": ("video", dict(gradAccum=2), 8, 5),
    "gradAccum_noiseGen": ("center", dict(gradAccum=2, noiseGen=True, nz=5),
                           8, 2),
    "gradAccum_conditionAdv": ("center", dict(gradAccum=2, conditionAdv=True),
                               8, 1),
    "remat": ("video", dict(remat=1), 4, 3),
    "adamMomentsBf16": ("center", dict(adamMomentsBf16=True), 2, 1),
    "useBias": ("center", dict(useBias=True), 2, 1),
    "useBias_video3d": ("video3d", dict(useBias=True), 2, 1),
}
GRAD = dict(rtol=2e-3, atol=2e-5)
BN = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(autouse=True)
def _python_decode(monkeypatch):
    """The JAX samplers' Python decode path, which the port's copies."""
    monkeypatch.setenv("VF_NO_NATIVE", "1")


def _opts(regime, n, **kw):
    kw = {**BASE, **REGIME[regime], "batchSize": n, **kw}
    return JaxOpt(**kw), Opt(device="cpu", **kw)


def _batch(regime, seed, n):
    """Smooth textures (uniform noise makes a batch-2 D chaotic enough to
    flip first-step Adam signs), each image and clip zero-mean (the JAX
    BatchNorm's one-pass variance loses f32 digits on offset-mean inputs,
    ROADMAP §C: on offset textures at batch 4 JAX's f32 D gradients were
    9.3e-3 off float64, the port's 2.0e-6), block masks."""
    rs = np.random.RandomState(seed)
    if regime == "video3d":
        mask = np.zeros((n, 1, 32, 32, 1), np.float32)
        mask[:, :, 8:20, 6:26] = 1.0
        return {"real": rs.uniform(-1, 1, (n, 2, 32, 32, 3))
                .astype(np.float32), "mask": mask}
    c = 6 if regime == "video" else 3
    real = np.stack([np.concatenate(
        [synthetic._texture(rs, 128, 128) for _ in range(c // 3)], axis=-1)
        for _ in range(n)]).astype(np.float32) / 127.5 - 1.0
    real = np.clip(real - real.mean(axis=(1, 2), keepdims=True), -1, 1)
    if regime == "center":
        return {"real": real}
    mask = np.zeros((n, 128, 128, 1), np.float32)
    mask[:, 40:80, 30:90] = 1.0
    return {"real": real, "mask": mask}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_state(opt, regime, jstate):
    """The port's TrainState with the JAX state's weights and statistics."""
    state = tstep.init_train_state(opt, regime,
                                   torch.Generator().manual_seed(0))
    sd_g, sd_d = convert.from_jax(jstate.params_g, jstate.state_g,
                                  jstate.params_d, jstate.state_d)
    state.gen.load_state_dict(sd_g, strict=True)
    state.disc.load_state_dict(sd_d, strict=True)
    return state


def _jax_noise(jopt, key, n):
    """The z the JAX step draws from its key (train/step.py:206,217)."""
    if not jopt.noiseGen:
        return None
    z = jstep._draw_noise(jax.random.split(key)[0], jopt, n)
    return torch.from_numpy(np.array(z))


def _allclose_trees(ours, ref, **tol):
    la, ta = jax.tree.flatten(ours)
    lb, tb = jax.tree.flatten(ref)
    assert ta == tb
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **tol)


def _jax_mu(opt_state):
    """The first moments of a JAX optimizer state, either kind."""
    return opt_state["mu"] if isinstance(opt_state, dict) else \
        opt_state[0].mu


def _port_mu(module, optimizer):
    mu = {n: optimizer.state[p]["exp_avg"].float()
          for n, p in module.named_parameters()}
    return convert.state_dict_to_tree(mu)[0]


_CACHE = {}


def _one_step(case):
    """JAX and the port one step from the same init and batch: (JAX state
    before, JAX state after, JAX metrics, port state, port metrics)."""
    if case not in _CACHE:
        regime, kw, n, seed = CASES[case]
        jopt, popt = _opts(regime, n, **kw)
        j0 = jax.jit(lambda k: jstep.init_train_state(k, jopt, regime))(
            jax.random.PRNGKey(0))
        batch = _batch(regime, seed, n)
        key = jax.random.PRNGKey(100)
        j1, jm = jax.jit(jstep.make_train_step(jopt, regime))(
            j0, _jb(batch), key)
        pstate = _port_state(popt, regime, j0)
        pm = tstep.make_train_step(popt, regime)(
            pstate, _tb(batch), noise=_jax_noise(jopt, key, n))
        _CACHE[case] = (j0, j1, jm, pstate, pm)
    return _CACHE[case]


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_metrics_match(case):
    _, _, jm, pstate, pm = _one_step(case)
    assert pstate.step == 1
    for k in tstep.METRIC_KEYS:
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def _feeds_batch_norm(tree, path):
    """Whether the conv whose leaf is at ``path`` feeds a BatchNorm in train
    mode: conv{k}/up{k} beside a bn{k}, the encoder's last conv and the
    noise projection (into ``bott_bn``)."""
    scope = tree
    for k in path[:-2]:
        scope = scope[k]
    layer = path[-2]
    index = layer.lstrip("convup")
    if f"bn{index}" in scope or layer == "noise":
        return True
    return path[0] == "enc" and f"conv{int(index) + 1}" not in scope \
        and "bott_bn" in tree


def _check_gradients(ours, ref):
    """Gradients (first moments over 1 - beta1) leaf by leaf at the gradient
    tolerance.  A conv bias that feeds a BatchNorm in train mode has an exact
    gradient of zero (the BN takes the batch mean out): on both sides its
    value is f32 rounding, up to 2.3e-5 on the useBias center step against
    a float64 step's 4e-14, so each side is held to zero within the gradient
    rtol of its conv weight's largest gradient instead."""
    flat = jax.tree_util.tree_flatten_with_path(ours)[0]
    keys = [tuple(k.key for k in path) for path, _ in flat]
    for path, (_, a), b in zip(keys, flat, jax.tree.leaves(ref)):
        a, b = np.asarray(a) / 0.5, np.asarray(b, np.float32) / 0.5
        if path[-1] == "b" and _feeds_batch_norm(ours, path):
            scope = ours
            for k in path[:-1]:
                scope = scope[k]
            bound = GRAD["rtol"] * np.abs(np.asarray(scope["w"]) / 0.5).max()
            assert np.abs(a).max() <= bound and np.abs(b).max() <= bound, \
                path
        else:
            np.testing.assert_allclose(a, b, **GRAD, err_msg=str(path))


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_params_and_bn_stats_after_one_step_match(case):
    """Gradients as Adam's first moments over (1 - beta1), the parameters
    after the update, the BN running statistics (gradAccum: chained through
    both microbatches)."""
    _, j1, _, pstate, _ = _one_step(case)
    bf16 = CASES[case][1].get("adamMomentsBf16", False)
    for module, optimizer, jopt_state, jparams, jbn in (
            (pstate.gen, pstate.opt_g, j1.opt_g, j1.params_g, j1.state_g),
            (pstate.disc, pstate.opt_d, j1.opt_d, j1.params_d, j1.state_d)):
        ours, ref = _port_mu(module, optimizer), _jax_mu(jopt_state)
        if bf16:
            # within the gradient tolerance, then one bf16 ulp of rounding
            for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
                b = np.asarray(b, np.float32)
                np.testing.assert_array_less(
                    np.abs(a - b), (2 ** -7 + GRAD["rtol"]) * np.abs(b)
                    + 0.5 * GRAD["atol"] + 1e-30)
        else:
            _check_gradients(ours, ref)
        tree, bn = convert.state_dict_to_tree(module.state_dict())
        _allclose_trees(tree, jparams, atol=4.1e-3)
        _allclose_trees(bn, jbn, **BN)


def test_option_specific_parameters_and_their_keys():
    """useBias: every conv has a ``bias`` (leaf ``b``), zero at init and
    trained; noiseGen: ``noise.weight`` and an nBottleneck+nz bottleneck;
    conditionAdv: ``ctx``, ``pred`` and ``join`` with BN state only under
    ``join``."""
    j0, _, _, ps, _ = _one_step("useBias")
    assert "b" in j0.params_g["enc"]["conv0"] and \
        "b" in j0.params_d["conv5"]
    assert ps.gen.enc.conv0.bias.abs().max() > 0          # Adam moved it
    j0, _, _, ps, _ = _one_step("noiseGen")
    assert ps.gen.noise.weight.shape == (5, 5, 1, 1)
    assert ps.gen.bott_bn.running_mean.shape == (16 + 5,)
    assert ps.gen.dec.up0.weight.shape[0] == 16 + 5
    j0, _, _, ps, _ = _one_step("conditionAdv")
    sd = ps.disc.state_dict()
    assert sd["ctx.weight"].shape == (8, 3, 5, 5)
    assert sd["pred.weight"].shape == (8, 3, 5, 5)
    assert sd["join.conv1.weight"].shape == (8, 16, 4, 4)
    assert {k.split(".")[0] for k in sd if "running" in k} == {"join"}
    assert set(sd) == set(convert.tree_to_state_dict(j0.params_d,
                                                     j0.state_d))


@pytest.mark.parametrize("case", ["adamMomentsBf16", "gradAccum"])
def test_three_step_trajectory_tracks(case):
    regime, kw, n, _ = CASES[case]
    jopt, popt = _opts(regime, n, **kw)
    state = jax.jit(lambda k: jstep.init_train_state(k, jopt, regime))(
        jax.random.PRNGKey(0))
    step = jax.jit(jstep.make_train_step(jopt, regime))
    pstate = _port_state(popt, regime, state)
    pstep = tstep.make_train_step(popt, regime)
    for i in range(3):
        batch = _batch(regime, 10 + i, n)
        state, m = step(state, _jb(batch), jax.random.PRNGKey(100 + i))
        pm = pstep(pstate, _tb(batch))
        for k in ("errD", "errG_l2"):
            np.testing.assert_allclose(pm[k].item(), float(m[k]), rtol=0.05,
                                       err_msg=f"{k} step {i + 1}")
    assert pstate.step == 3
    if kw.get("adamMomentsBf16"):
        assert isinstance(pstate.opt_g, AdamBf16Moments)
        st = pstate.opt_g.state[pstate.gen.enc.conv0.weight]
        assert st["exp_avg"].dtype == torch.bfloat16
        assert st["step"].dtype == torch.int32 and int(st["step"]) == 3


# --- the port's own mirrors of tests/test_train_step.py ---------------------

def _port_step(regime, n, batch, seed=5, noise=None, **kw):
    _, popt = _opts(regime, n, **kw)
    state = tstep.init_train_state(popt, regime,
                                   torch.Generator().manual_seed(seed))
    m = tstep.make_train_step(popt, regime)(state, _tb(batch), noise=noise)
    return state, m


def test_grad_accum_matches_one_microbatch_step():
    """k identical microbatches average to the one microbatch's gradients:
    gradAccum=3 on the tiled batch steps the parameters as a gradAccum=1
    step on one microbatch does (the running statistics chain 3 times)."""
    micro = _batch("center", 2, 2)
    tiled = {"real": np.concatenate([micro["real"]] * 3)}
    s_acc, m_acc = _port_step("center", 6, tiled, gradAccum=3)
    s_one, m_one = _port_step("center", 2, micro)
    for k in m_one:
        np.testing.assert_allclose(m_acc[k].item(), m_one[k].item(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for net in ("gen", "disc"):
        for a, b in zip(getattr(s_acc, net).parameters(),
                        getattr(s_one, net).parameters()):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), atol=4.1e-3)
    assert not torch.allclose(s_acc.gen.bott_bn.running_mean,
                              s_one.gen.bott_bn.running_mean)


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["plain", "gradAccum"])
def test_remat_matches_the_plain_step_running_stats_included(grad_accum):
    """The recompute replays the forward with running-statistic updates
    off: parameters, moments and BN statistics equal the plain step's."""
    batch = _batch("video", 3, 4)
    s_plain, m_plain = _port_step("video", 4, batch, gradAccum=grad_accum)
    s_remat, m_remat = _port_step("video", 4, batch, gradAccum=grad_accum,
                                  remat=1)
    for k in m_plain:
        np.testing.assert_allclose(m_remat[k].item(), m_plain[k].item(),
                                   rtol=1e-6, err_msg=k)
    for net in ("gen", "disc"):
        a = getattr(s_remat, net).state_dict()
        b = getattr(s_plain, net).state_dict()
        for k in b:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       atol=1e-6, err_msg=k)


def test_remat_recompute_leaves_running_stats_alone(monkeypatch):
    """Without the frozen recompute the statistics would move a second
    time: count the BatchNorm calls that update them."""
    from video_filler_tpu_torch.ops import layers
    updates = {"n": 0}
    real_bn = layers.F.batch_norm

    def counting(x, rm, rv, *a, **kw):
        if kw.get("training") and rm is not None and kw["momentum"] > 0:
            updates["n"] += 1
        return real_bn(x, rm, rv, *a, **kw)

    monkeypatch.setattr(layers.F, "batch_norm", counting)
    counts = []
    for remat in (0, 1):
        updates["n"] = 0
        _port_step("center", 2, _batch("center", 4, 2), remat=remat)
        counts.append(updates["n"])
    assert counts[0] == counts[1] > 0


def test_grad_accum_refuses_a_batch_it_does_not_divide():
    with pytest.raises(ValueError, match="batchSize 3 must divide by "
                                         "gradAccum 2"):
        _port_step("center", 3, _batch("center", 5, 3), gradAccum=2)


@pytest.mark.parametrize("regime", ["video", "video3d", "logo", "wholeim"])
def test_condition_adv_refused_outside_center(regime):
    kw = REGIME.get(regime, {})
    opt = Opt(device="cpu", **{**BASE, **kw, "conditionAdv": True})
    with pytest.raises(ValueError, match="conditionAdv"):
        tstep.make_train_step(opt, regime)


def test_noise_gen_step_draws_z_from_its_generator():
    batch = _tb(_batch("center", 6, 2))
    _, popt = _opts("center", 2, noiseGen=True, nz=5, noisetype="uniform")
    ms = []
    for seed in (1, 1, 2):
        state = tstep.init_train_state(popt, "center",
                                       torch.Generator().manual_seed(0))
        ms.append(tstep.make_train_step(popt, "center")(
            state, batch, gen=torch.Generator().manual_seed(seed))["errD"])
    assert ms[0] == ms[1] and ms[0] != ms[2]
    z = tstep.draw_noise(popt, torch.Generator().manual_seed(3), 64, "cpu")
    assert z.shape == (64, 1, 1, 5) and z.min() >= -1 and z.max() <= 1
    with pytest.raises(ValueError, match="noise= or gen="):
        tstep.make_train_step(popt, "center")(state, batch)


# --- checkpoints both ways ----------------------------------------------------

@pytest.mark.parametrize("case", ["adamMomentsBf16", "useBias",
                                  "useBias_video3d"])
def test_jax_checkpoint_restores_into_the_port_and_steps(case, tmp_path):
    """JAX writes its state after a step; the port restores it (bf16
    moments back to bf16, conv biases to their convs) and steps on as JAX
    does from the same file."""
    regime, kw, n, _ = CASES[case]
    jopt, popt = _opts(regime, n, **kw)
    _, j1, _, _, _ = _one_step(case)
    path = jckpt.save_checkpoint(str(tmp_path), "j", 1, j1)
    pstate = tstep.init_train_state(popt, regime,
                                    torch.Generator().manual_seed(9))
    ckpt.restore_checkpoint(path, pstate)
    assert pstate.step == 1
    assert ckpt.flatten_state(pstate).keys() == jckpt._flatten(j1).keys()
    for k, v in ckpt.flatten_state(pstate).items():
        np.testing.assert_array_equal(v, jckpt._flatten(j1)[k], err_msg=k)
    if kw.get("adamMomentsBf16"):
        st = pstate.opt_g.state[pstate.gen.enc.conv0.weight]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16
    batch = _batch(regime, 7, n)
    key = jax.random.PRNGKey(7)
    j2, jm = jax.jit(jstep.make_train_step(jopt, regime))(j1, _jb(batch),
                                                          key)
    pm = tstep.make_train_step(popt, regime)(pstate, _tb(batch))
    for k in tstep.METRIC_KEYS:
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    _allclose_trees(convert.state_dict_to_tree(pstate.gen.state_dict())[0],
                    j2.params_g, atol=4.1e-3)


@pytest.mark.parametrize("case", ["adamMomentsBf16", "useBias",
                                  "useBias_video3d"])
def test_port_checkpoint_restores_into_jax(case, tmp_path):
    regime, kw, n, _ = CASES[case]
    jopt, _ = _opts(regime, n, **kw)
    j0, _, _, pstate, _ = _one_step(case)
    path = ckpt.save_checkpoint(str(tmp_path), "p", 1, pstate)
    restored, _ = jckpt.restore_checkpoint(path, j0)
    assert int(restored.step) == 1
    ours = ckpt.flatten_state(pstate)
    ref = jckpt._flatten(restored)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    if kw.get("adamMomentsBf16"):
        assert restored.opt_g["mu"]["enc"]["conv0"]["w"].dtype == jnp.bfloat16
        assert ".opt_g['count']" in ours and ".opt_g[0].count" not in ours
    else:
        assert ours[".params_g['enc']['conv0']['b']"].shape == (8,)


def test_loop_trains_checkpoints_and_resumes_each_option(tmp_path,
                                                         monkeypatch):
    """The trainer CLI with every option at once on center, a checkpoint,
    then its autoResume: the bf16 moments and conv biases come back."""
    synthetic.make_image_folder(str(tmp_path / "data"), n=8, h=140, w=150)
    monkeypatch.chdir(tmp_path)
    args = ["regime=center", "device=cpu", "batchSize=4", "nef=8", "ngf=8",
            "ndf=8", "nBottleneck=16", "wtl2=0.999", "overlapPred=4",
            "computeDtype=float32", "ntrain=8", "nThreads=1", "loadSize=0",
            "manualSeed=3", "display_iter=1", "DATA_ROOT=data",
            "checkpointEvery=1", "name=opts", "conditionAdv=1", "noiseGen=1",
            "nz=5", "gradAccum=2", "remat=1", "adamMomentsBf16=1",
            "useBias=1"]
    state = loop.main([*args, "niter=1"])
    assert state.step == 2
    assert (tmp_path / "display" / "opts_e1_s2_fake.png").exists()
    state = loop.main([*args, "niter=2", "autoResume=1"])
    assert state.step == 4
    assert isinstance(state.opt_g, AdamBf16Moments)
    assert int(state.opt_g.state[state.gen.noise.weight]["step"]) == 4
    with np.load(tmp_path / "checkpoints" / "opts_2_state.npz") as f:
        assert ".opt_d['nu']['join']['conv1']['b']" in f.files


# --- noiseGen through eval and serve ------------------------------------------

def _noise_ckpt(tmp_path):
    """A JAX center noiseGen checkpoint whose running statistics are the
    batch statistics of a train-mode pass on random contexts and draws (the
    init's mean 0 / var 1 would shrink every activation towards zero in
    eval mode), so that z and eval mode matter."""
    jopt, popt = _opts("center", 2, noiseGen=True, nz=5, manualSeed=222)
    st = jstep.init_train_state(jax.random.PRNGKey(3), jopt, "center")
    rs = np.random.RandomState(4)
    x = (jnp.asarray(rs.uniform(-1, 1, (8, 128, 128, 3)), jnp.float32),
         jnp.asarray(rs.normal(size=(8, 1, 1, 5)), jnp.float32))
    _, moved = jax_build(jopt, "center")[0].apply(st.params_g, st.state_g, x,
                                                  train=True)
    # one momentum-0.1 update from the init: batch = (new - 0.9 old) / 0.1
    batch_stats = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1,
                               moved, st.state_g)
    st = st._replace(state_g=batch_stats)
    return jopt, popt, jckpt.save_checkpoint(str(tmp_path), "ng", 1, st)


def test_evaluate_and_bench_inference_take_noise(tmp_path):
    """evaluate with the JAX side's draws (its crops and flips, and one z
    per batch) matches JAX's; bench_inference runs the (ctx, z) G."""
    jopt, popt, path = _noise_ckpt(tmp_path)
    synthetic.make_image_folder(str(tmp_path / "data"), n=6, h=150, w=170)
    kw = dict(net=path, DATA_ROOT=str(tmp_path / "data"), loadSize=140)
    jopt, popt = jopt.replace(**kw), popt.replace(**kw)
    ref = jmetrics.evaluate(jopt, "center", n_batches=2, seed=5)
    key, draws = jax.random.PRNGKey(5), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        d = {"flip": torch.from_numpy(np.array(jax.random.uniform(
            jax.random.split(sub)[1], (2,)) < 0.5))}
        key, kz = jax.random.split(key)
        d["z"] = torch.from_numpy(np.array(
            jax.random.normal(kz, (2, 1, 1, 5))))
        draws.append(d)
    got = metrics.evaluate(popt, "center", n_batches=2, seed=5, draws=draws)
    for k in ("l2", "psnr_db", "ssim", "hole_l2"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    gen = common.load_generator(popt, "center", path, "cpu")
    s = metrics.bench_inference(popt, "center", iters=2, loaded=gen)
    assert s["clips_per_sec"] > 0
    x = torch.zeros(2, 128, 128, 3)
    with torch.inference_mode():
        a, b = (gen(common.gen_input(popt, x, noise=z)) for z in (
            torch.zeros(2, 1, 1, 5), torch.ones(2, 1, 1, 5)))
    assert not torch.equal(a, b)               # z reaches the output


def test_eval_clis_pass_the_jax_noise(tmp_path):
    """demo, test_patch and eval.video with the JAX CLIs' z (drawn from
    PRNGKey(manualSeed)) match the JAX CLIs."""
    from video_filler_tpu.eval.demo import run_demo as jrun_demo
    from video_filler_tpu.eval.test_patch import run_test as jrun_test
    from video_filler_tpu_torch.eval.demo import run_demo
    from video_filler_tpu_torch.eval.test_patch import run_test
    jopt, popt, path = _noise_ckpt(tmp_path)
    synthetic.make_image_folder(str(tmp_path / "demo"), n=2, h=140, w=150)
    kw = dict(net=path, imDir=str(tmp_path / "demo" / "images"),
              DATA_ROOT=str(tmp_path / "demo"), loadSize=140)
    jopt, popt = jopt.replace(**kw), popt.replace(**kw)
    z = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(222), (2, 1, 1, 5))))
    ref = jrun_demo(jopt, out_path=str(tmp_path / "j.png"))
    got = run_demo(popt, out_path=str(tmp_path / "p.png"), noise=z)
    np.testing.assert_allclose(got["pred_center"], ref["pred_center"],
                               rtol=1e-5, atol=1e-6)
    ref = jrun_test(jopt, out_prefix=str(tmp_path / "j"))
    got = run_test(popt, out_prefix=str(tmp_path / "p"), noise=z)
    np.testing.assert_allclose(got["inpainted"], ref["inpainted"], rtol=1e-5,
                               atol=1e-6)


def test_video_eval_passes_noise_and_tiled_evals_refuse_it(tmp_path):
    from video_filler_tpu_torch.eval.stream import run_stream
    from video_filler_tpu_torch.eval.video import run_test_vid
    from video_filler_tpu_torch.eval.wholeim import run_wholeim
    synthetic.make_video_corpus(str(tmp_path / "corpus"), n_videos=1,
                                frames=4, h=180, w=240)
    synthetic.make_mask_png(str(tmp_path / "mask.png"), h=180, w=240)
    _, popt = _opts("video", 2, noiseGen=True, nz=5)
    state = tstep.init_train_state(popt, "video",
                                   torch.Generator().manual_seed(0))
    path = ckpt.save_checkpoint(str(tmp_path), "v", 1, state)
    popt = popt.replace(net=path, DATA_ROOT=str(tmp_path / "corpus"),
                        maskName=str(tmp_path / "mask.png"), loadSize=150,
                        manualSeed=2)
    outs = [run_test_vid(popt, out_dir=str(tmp_path / f"v{i}"),
                         noise=torch.full((2, 1, 1, 5), float(i)))["fake"]
            for i in (0, 0, 3)]
    assert np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    for fn in (run_wholeim, run_stream):
        with pytest.raises(ValueError, match="noiseGen does not compose "
                                             "with tiled whole-frame eval"):
            fn(popt)


def _post(port, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://localhost:{port}/inpaint",
                                 data=buf.getvalue(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            with np.load(io.BytesIO(r.read()), allow_pickle=False) as d:
                return 200, d["out"]
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_noise_over_http_matches_the_jax_server(tmp_path):
    """A noiseGen center server: posted noise in each accepted shape matches
    the JAX server's function on the same z; rows without noise get zeros;
    a bad shape is a 400."""
    jopt, popt, path = _noise_ckpt(tmp_path)
    rs = np.random.RandomState(6)
    ctx = rs.randint(0, 256, (2, 128, 128, 3), np.uint8)
    z = rs.normal(size=(2, 1, 1, 5)).astype(np.float32)
    mask = np.ones((4, 128, 128, 1), np.uint8)
    jsrv = JaxServer(jopt.replace(batchSize=4), "center", path,
                     device_thread=False)
    try:
        def jax_rows(zs):
            full = np.zeros((4, 1, 1, 5), np.float32)
            full[:2] = zs
            c = np.zeros((4, 128, 128, 3), np.uint8)
            c[:2] = ctx
            return np.asarray(jsrv._serve_fn(jsrv._params, jsrv._bn, c, mask,
                                             full))[:2]
        ref_z, ref_0 = jax_rows(z), jax_rows(0.0)
        ref_b = jax_rows(np.broadcast_to(z[0], (2, 1, 1, 5)))
    finally:
        jsrv.close()
    srv = InpaintServer(popt.replace(batchSize=4), "center", path,
                        max_delay_ms=1.0)
    try:
        for noise, ref in ((z, ref_z), (z[0, 0, 0], ref_b), (z[0], ref_b),
                           (None, ref_0)):
            arrays = {"ctx": ctx} if noise is None else {"ctx": ctx,
                                                         "noise": noise}
            code, out = _post(srv.port, **arrays)
            assert code == 200
            assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
        assert not np.array_equal(ref_z, ref_0)
        code, body = _post(srv.port, ctx=ctx, noise=np.zeros((2, 1, 1, 4)))
        assert code == 400 and b"noise must be (B,1,1,5)" in body
        with pytest.raises(ValueError, match=r"noise must be \(2,1,1,5\)"):
            srv.infer(ctx, None, np.zeros((2, 1, 1, 4), np.float32))
    finally:
        srv.close()


def test_server_noise_refusals(tmp_path):
    """noiseGen=0 answers posted noise with a 400; the video full-frame
    mode and video3d refuse a noiseGen G."""
    _, popt, path = _noise_ckpt(tmp_path)
    plain = tstep.init_train_state(popt.replace(noiseGen=False), "center",
                                   torch.Generator().manual_seed(0))
    plain_path = ckpt.save_checkpoint(str(tmp_path), "plain", 1, plain)
    srv = InpaintServer(popt.replace(noiseGen=False), "center", plain_path,
                        max_delay_ms=1.0)
    try:
        code, body = _post(srv.port, ctx=np.zeros((128, 128, 3), np.uint8),
                           noise=np.zeros(5, np.float32))
        assert code == 400 and b"takes no noise (noiseGen=0)" in body
    finally:
        srv.close()
    for regime, kw, match in (
            ("video", dict(frameH=180, frameW=240, predLen=2),
             "video full-frame serving does not compose with noiseGen"),
            ("video3d", REGIME["video3d"], "video3d has neither")):
        with pytest.raises(SystemExit, match=match):
            InpaintServer(popt.replace(**kw), regime, path)
