"""Checkpoints of the port against the JAX package's: the same file format
both ways, resume, G-only import, retention and the async error path.

Tolerances: a checkpoint moves leaves exactly (f32 both ways, the Adam
count and the step as int32).  A step after a resume is held as a first
step is (tests/test_torch_step.py): metrics rtol 1e-4, parameters atol
4.1e-3, BN statistics rtol 1e-3 / atol 1e-5, Adam moments rtol 2e-3 /
atol 2e-5 (they are sums of gradients).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.checkpoint import ckpt as jckpt
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.checkpoint import ckpt, convert
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import synthetic
from video_filler_tpu_torch.models import build_generator, specs_for_regime
from video_filler_tpu_torch.train import loop
from video_filler_tpu_torch.train import step as tstep

torch.set_num_threads(1)

SMALL = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=2, predLen=2,
             wtl2=0.999, weight_nomask=0.05, computeDtype="float32")


def _batch(seed):
    rs = np.random.RandomState(seed)
    mask = np.zeros((2, 128, 128, 1), np.float32)
    mask[:, 40:80, 30:90] = 1.0
    real = np.stack([np.concatenate([synthetic._texture(rs, 128, 128)
                                     for _ in range(2)], axis=-1)
                     for _ in range(2)]).astype(np.float32) / 127.5 - 1.0
    return {"real": real, "mask": mask}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_state(regime="video", seed=0, **kw):
    opt = Opt(device="cpu", **{**SMALL, **kw})
    return opt, tstep.init_train_state(opt, regime,
                                       torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def jax_video():
    """A JAX video state after one step, and the jitted step."""
    jopt = JaxOpt(**SMALL)
    step = jax.jit(jstep.make_train_step(jopt, "video"))
    state = jstep.init_train_state(jax.random.PRNGKey(0), jopt, "video")
    state, _ = step(state, _jb(_batch(1)), jax.random.PRNGKey(1))
    return jopt, step, state


@pytest.mark.parametrize("regime", ["center", "video", "logo", "wholeim"])
def test_keys_shapes_and_dtypes_match_a_jax_train_state(regime):
    kw = dict(overlapPred=4) if regime == "center" else {}
    jstate = jstep.init_train_state(jax.random.PRNGKey(0),
                                    JaxOpt(**{**SMALL, **kw}), regime)
    ref = jckpt._flatten(jstate)
    _, pstate = _port_state(regime, **kw)
    ours = ckpt.flatten_state(pstate)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape, k
        assert ours[k].dtype == v.dtype, k
    assert ".opt_g[0].mu['enc']['conv0']['w']" in ours


def test_jax_checkpoint_resumes_in_the_port(tmp_path, jax_video):
    jopt, step, state = jax_video
    path = jckpt.save_checkpoint(str(tmp_path), "jx", 1, state,
                                 meta={"epoch": 1, "regime": "video"})
    target = jstep.init_train_state(jax.random.PRNGKey(5), jopt, "video")
    jstate, _ = jckpt.restore_checkpoint(path, target)
    new_j, m_j = step(jstate, _jb(_batch(2)), jax.random.PRNGKey(2))

    opt, pstate = _port_state(seed=9)
    assert ckpt.restore_checkpoint(path, pstate) == {"epoch": 1,
                                                     "regime": "video"}
    assert pstate.step == 1
    m_p = tstep.make_train_step(opt, "video")(pstate, _tb(_batch(2)))
    assert pstate.step == 2
    for k in tstep.METRIC_KEYS:
        np.testing.assert_allclose(m_p[k].item(), float(m_j[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    flat = ckpt.flatten_state(pstate)
    ref = jckpt._flatten(new_j)
    for k, v in ref.items():
        if ".params_" in k:
            np.testing.assert_allclose(flat[k], v, atol=4.1e-3, err_msg=k)
        elif ".state_" in k:
            np.testing.assert_allclose(flat[k], v, rtol=1e-3, atol=1e-5,
                                       err_msg=k)
        elif ".mu" in k or ".nu" in k:
            np.testing.assert_allclose(flat[k], v, rtol=2e-3, atol=2e-5,
                                       err_msg=k)
        elif k.endswith(".count") or k == ".step":
            assert int(flat[k]) == int(v) == 2, k


def test_port_checkpoint_restores_in_jax(tmp_path):
    opt, pstate = _port_state()
    tstep.make_train_step(opt, "video")(pstate, _tb(_batch(1)))
    path = ckpt.save_checkpoint(str(tmp_path), "pt", 1, pstate,
                                meta={"epoch": 1})
    target = jstep.init_train_state(jax.random.PRNGKey(3), JaxOpt(**SMALL),
                                    "video")
    restored, meta = jckpt.restore_checkpoint(path, target)
    assert meta == {"epoch": 1} and int(restored.step) == 1
    params_g, state_g = convert.state_dict_to_tree(pstate.gen.state_dict())
    mu_g, _ = convert.state_dict_to_tree(
        {n: pstate.opt_g.state[p]["exp_avg"]
         for n, p in pstate.gen.named_parameters()})
    for ours, ref in ((params_g, restored.params_g),
                      (state_g, restored.state_g),
                      (mu_g, restored.opt_g[0].mu)):
        la, ta = jax.tree.flatten(ours)
        lb, tb = jax.tree.flatten(ref)
        assert ta == tb
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert int(restored.opt_g[0].count) == int(restored.opt_d[0].count) == 1


def test_port_round_trip_resumes_bitwise(tmp_path):
    opt, a = _port_state()
    step = tstep.make_train_step(opt, "video")
    step(a, _tb(_batch(1)))
    path = ckpt.save_checkpoint(str(tmp_path), "rt", 1, a)
    _, b = _port_state(seed=4)
    ckpt.restore_checkpoint(path, b)
    ma, mb = step(a, _tb(_batch(2))), step(b, _tb(_batch(2)))
    for k in tstep.METRIC_KEYS:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(a.gen.state_dict().values(), b.gen.state_dict().values()):
        assert torch.equal(x, y)
    assert a.step == b.step == 2


def test_restore_subtree_imports_the_generator_only(tmp_path):
    opt, pstate = _port_state()
    tstep.make_train_step(opt, "video")(pstate, _tb(_batch(1)))
    path = ckpt.save_checkpoint(str(tmp_path), "g_only", 1, pstate)
    gspec = specs_for_regime(Opt(device="cpu", **{**SMALL, "ndf": 16}),
                             "video")[0]
    g = ckpt.restore_subtree(path, build_generator(
        gspec, torch.Generator().manual_seed(8)))
    for x, y in zip(g.state_dict().values(),
                    pstate.gen.state_dict().values()):
        assert torch.equal(x, y)
    wrong = specs_for_regime(Opt(device="cpu", **{**SMALL, "ngf": 16}),
                             "video")[0]
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_subtree(path, build_generator(
            wrong, torch.Generator().manual_seed(8)))


def test_shape_mismatch_and_bf16_moments_fail_loudly(tmp_path):
    _, pstate = _port_state()
    path = ckpt.save_checkpoint(str(tmp_path), "x", 1, pstate)
    _, wide = _port_state(nef=16)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(path, wide)
    jstate = jstep.init_train_state(
        jax.random.PRNGKey(0), JaxOpt(**{**SMALL, "adamMomentsBf16": True}),
        "video")
    path = jckpt.save_checkpoint(str(tmp_path), "bf16m", 1, jstate)
    # a bf16-moment file does not resume an f32-Adam run: both are named
    with pytest.raises(ValueError, match=r"holds bf16 Adam moments "
                       r"\(adamMomentsBf16=1\) for opt_g, but this run uses "
                       r"f32 Adam moments \(adamMomentsBf16=0\)"):
        ckpt.restore_checkpoint(path, pstate)


def test_5d_conv_leaves_convert_by_name_both_ways():
    """A video3d tree (the JAX package's, at the JAX suite's 3-D widths):
    its 5-D conv weights change layout, DHWIO -> OIDHW and (kt,kh,kw,cin,
    cout) -> (cin,cout,kt,kh,kw), and keep the leaf name ``w`` on the way
    back; the BN leaves cross unchanged.  The converter once passed every
    non-4-D leaf through unchanged and named each non-4-D ``weight`` a BN
    gamma (ROADMAP §C)."""
    from video_filler_tpu.models import build_for_regime as jax_build
    jg, jd = jax_build(JaxOpt(nef=8, ngf=8, ndf=8, nBottleneck=32,
                              fineSize=32, video3dLevels=3, predLen=2),
                       "video3d")
    rs = np.random.RandomState(0)
    for net in (jg, jd):
        params, state = jax.tree.map(
            lambda s: rs.randn(*s.shape).astype(np.float32),
            jax.eval_shape(net.init, jax.random.PRNGKey(0)))
        sd = convert.tree_to_state_dict(params, state)
        conv0 = params["conv0"]["w"] if net is jd else \
            params["enc"]["conv0"]["w"]
        key = "conv0.weight" if net is jd else "enc.conv0.weight"
        assert conv0.shape == (3, 4, 4, 3, 8 if net is jg else 4)
        np.testing.assert_array_equal(sd[key].numpy(),
                                      conv0.transpose(4, 3, 0, 1, 2))
        if net is jg:
            up1 = params["dec"]["up1"]["w"]
            assert up1.shape == (3, 4, 4, 16, 8)
            np.testing.assert_array_equal(sd["dec.up1.weight"].numpy(),
                                          up1.transpose(3, 4, 0, 1, 2))
            assert sd["dec.up0.weight"].shape == (32, 16, 2, 4, 4)
            assert sd["enc.bn1.weight"].shape == (8,)
        back_p, back_s = convert.state_dict_to_tree(sd)
        for ours, ref in ((back_p, params), (back_s, state)):
            la, ta = jax.tree.flatten(ours)
            lb, tb = jax.tree.flatten(ref)
            assert ta == tb
            for x, y in zip(la, lb):
                np.testing.assert_array_equal(x, y)


def test_restore_latest_and_prune(tmp_path):
    _, pstate = _port_state()
    for e in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), "runA", e, pstate)
    ckpt.save_checkpoint(str(tmp_path), "runB", 9, pstate)
    ckpt.save_checkpoint(str(tmp_path), "runA", "best", pstate)
    assert ckpt.restore_latest(str(tmp_path), "runA", pstate)[1] == 4
    assert ckpt.restore_latest(str(tmp_path), "missing", pstate) is None
    assert ckpt.prune_checkpoints(str(tmp_path), "runA", 0) == []
    deleted = ckpt.prune_checkpoints(str(tmp_path), "runA", 2)
    assert sorted(os.path.basename(p) for p in deleted) == \
        ["runA_1_state.npz", "runA_2_state.npz"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "runA_3_state.npz", "runA_4_state.npz", "runA_best_state.npz",
        "runB_9_state.npz"]
    assert ckpt.prune_checkpoints(str(tmp_path / "nope"), "x", 3) == []


def test_async_write_failure_surfaces(tmp_path, monkeypatch):
    _, pstate = _port_state()

    def boom(*a, **kw):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt.np, "savez", boom)
    ckpt.save_checkpoint(str(tmp_path), "x", 1, pstate, async_write=True)
    with pytest.raises(RuntimeError, match="NOT saved"):
        ckpt.wait_pending_saves()
    ckpt.wait_pending_saves()         # the error queue was drained
    # a pending error also surfaces at the next async save
    ckpt.save_checkpoint(str(tmp_path), "x", 2, pstate, async_write=True)
    ckpt._PENDING_SAVES[-1].join(timeout=30)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="NOT saved"):
        ckpt.save_checkpoint(str(tmp_path), "x", 3, pstate, async_write=True)
    ckpt.wait_pending_saves()
    assert not (tmp_path / "x_1_state.npz").exists()


def test_async_save_holds_the_state_of_its_call(tmp_path):
    """The step updates weights in place; an async save must write what
    they were when it was called."""
    opt, pstate = _port_state()
    before = {k: v.clone() for k, v in pstate.gen.state_dict().items()}
    path = ckpt.save_checkpoint(str(tmp_path), "a", 1, pstate,
                                async_write=True)
    tstep.make_train_step(opt, "video")(pstate, _tb(_batch(1)))
    ckpt.wait_pending_saves()
    g = build_generator(specs_for_regime(opt, "video")[0],
                        torch.Generator().manual_seed(1))
    ckpt.restore_subtree(path, g)
    for k, v in g.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_resumed_run_continues_the_step_seeds(tmp_path, monkeypatch):
    """An interrupted run resumed by autoResume draws the step seeds the
    uninterrupted run drew, and a loader seed with the step folded in."""
    synthetic.make_video_corpus(str(tmp_path / "corpus"), n_videos=1,
                                frames=6, h=140, w=150)
    seeds, loader_seeds = [], []
    real_step_seed = loop.step_seed
    real_loader = loop.DataLoader

    def recording_step_seed(seed, global_step):
        seeds.append(global_step)
        return real_step_seed(seed, global_step)

    def recording_loader(sampler, n_threads, seed, prefetch_depth):
        loader_seeds.append(seed)
        return real_loader(sampler, n_threads, seed, prefetch_depth)

    monkeypatch.setattr(loop, "step_seed", recording_step_seed)
    monkeypatch.setattr(loop, "DataLoader", recording_loader)
    monkeypatch.chdir(tmp_path)
    args = ["regime=video", "device=cpu", "batchSize=2", "nef=8", "ngf=8",
            "ndf=8", "nBottleneck=16", "predLen=2", "wtl2=0.999",
            "computeDtype=float32", "ntrain=4", "nThreads=0", "loadSize=0",
            "display=0", "manualSeed=3", "DATA_ROOT=corpus"]
    loop.main([*args, "niter=2", "checkpointEvery=5", "name=whole"])
    whole = list(seeds)
    seeds.clear()
    loop.main([*args, "niter=1", "checkpointEvery=1", "name=cut"])
    state = loop.main([*args, "niter=2", "checkpointEvery=5", "autoResume=1",
                       "name=cut"])
    assert whole == [0, 1, 2, 3]
    assert seeds == whole
    assert state.step == 4
    assert loader_seeds == [3, 3, 3 + 104729 * 2]


def test_sigterm_checkpoints_at_the_next_step_and_exits(tmp_path,
                                                        monkeypatch):
    """SIGTERM during a step: the loop finishes it, saves the live state
    under the current epoch and returns; autoResume picks it up."""
    import signal
    synthetic.make_video_corpus(str(tmp_path / "corpus"), n_videos=1,
                                frames=6, h=140, w=150)
    real_make = loop.make_train_step

    def make_preempted(opt, regime, with_init=False):
        step = real_make(opt, regime, with_init)

        def preempted_step(state, batch, init_net=None):
            metrics = step(state, batch, init_net)
            os.kill(os.getpid(), signal.SIGTERM)
            return metrics
        return preempted_step

    monkeypatch.setattr(loop, "make_train_step", make_preempted)
    monkeypatch.chdir(tmp_path)
    before = signal.getsignal(signal.SIGTERM)
    args = ["regime=video", "device=cpu", "batchSize=2", "nef=8", "ngf=8",
            "ndf=8", "nBottleneck=16", "predLen=2", "wtl2=0.999",
            "computeDtype=float32", "ntrain=4", "nThreads=0", "loadSize=0",
            "display=0", "manualSeed=3", "DATA_ROOT=corpus", "niter=3",
            "checkpointEvery=5", "name=pre"]
    state = loop.main(args)
    assert state.step == 1
    assert signal.getsignal(signal.SIGTERM) == before   # handler restored
    with np.load("checkpoints/pre_1_state.npz") as f:
        meta = json.loads(str(f["__meta__"]))
    assert meta["preempted_at_step"] == 1 and meta["epoch"] == 1
    monkeypatch.setattr(loop, "make_train_step", real_make)
    assert loop.main([*args, "autoResume=1"]).step == 1 + 2 * 2
