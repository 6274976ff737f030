"""Multi-process training with the port (video_filler_tpu_torch/parallel/
distributed.py, launch.py and the loop's multi-process branches): gloo
worlds of 2 processes on the CPU, each rank running ``train.loop.main``
(the counterpart of tests/test_distributed.py, whose worlds are 2
jax.distributed processes).  Loop results after 2 steps are held to atol
8.1e-3 against one process (two first-step Adam sign flips, as there).
The gradients are held after one step, as both nets' Adam first moments,
to 0.1 of each leaf's largest value (test_torch_parallel.py's limit):
after two, a weight whose tiny first gradient flipped sign has moved by
2*lr_G and shifts the second gradient by as much as 0.14 of a leaf (on
the card, tests/gradient_readings.py for the CPU)."""

import os
import pathlib
import shutil
import time

import jax
import numpy as np
import pytest
import torch

import _torch_workers as workers
from test_torch_parallel import check_gradients
from video_filler_tpu.checkpoint import restore_checkpoint as jax_restore
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.checkpoint import ckpt, convert
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data.synthetic import _texture
from video_filler_tpu_torch.entry import dryrun_multichip
from video_filler_tpu_torch.parallel import distributed
from video_filler_tpu_torch.parallel.launch import free_port, run_world
from video_filler_tpu_torch.train import loop
from video_filler_tpu_torch.train import step as tstep
from video_filler_tpu_torch.utils.io import save_png

NET = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, batchSize=8, wtl2=0.999,
           computeDtype="float32")
LOOP_ATOL = 8.1e-3
WORLD_S = 120


def _args(data, **kw):
    base = dict(NET, device="cpu", DATA_ROOT=data, loadSize=128,
                nThreads=0, niter=2, ntrain=8, manualSeed=222, display=0,
                checkpointEvery=5)
    base.update(kw)
    return ["regime=center"] + [f"{k}={v}" for k, v in base.items()]


def _images(root, distinct: bool):
    d = os.path.join(root, "images")
    os.makedirs(d)
    rs = np.random.RandomState(0)
    img = _texture(rs, 128, 128)
    for i in range(8):
        save_png(os.path.join(d, f"im_{i:04d}.png"),
                 _texture(rs, 128, 128) if distinct else img)
    return root


@pytest.fixture(scope="module")
def same_images(tmp_path_factory):
    """8 identical images: the global batch is the same whichever data
    rank sampled which rows (the JAX test's trick)."""
    return _images(str(tmp_path_factory.mktemp("same") / "data"), False)


def _single(tmp, args):
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        return loop.main(args)
    finally:
        os.chdir(cwd)


def _flat(gen_sd):
    return np.concatenate([np.asarray(v).ravel()
                           for _, v in sorted(gen_sd.items())])


def test_initialize_does_nothing_without_the_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (distributed.process_count(), distributed.process_index()) == \
        (1, 0)


def test_initialize_raises_with_the_env_and_no_peer(monkeypatch):
    """A world described by the environment whose handshake fails raises:
    the ranks must not train on alone."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    t0 = time.monotonic()
    with pytest.raises(Exception):
        distributed.initialize(device="cpu", timeout_s=3)
    assert time.monotonic() - t0 < 60
    assert not torch.distributed.is_initialized()


def test_process_batch_slice():
    assert distributed.process_batch_slice(64) == (0, 64)
    assert distributed.process_batch_slice(64, 4, 1) == (16, 16)
    with pytest.raises(ValueError, match="must divide"):
        distributed.process_batch_slice(10, 4, 0)
    # a data rank's share of each gradAccum microbatch
    assert distributed.data_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    assert distributed.data_rows(8, 2, 1).tolist() == [4, 5, 6, 7]


@pytest.fixture(scope="module")
def two_rank_world(same_images, tmp_path_factory):
    """One world of two gloo ranks: the loop with checkpoints, a one-step
    run, and a run with an epoch hook; (the ranks' results, the cwd)."""
    cwd = str(tmp_path_factory.mktemp("mh"))
    runs = run_world(2, workers.many, ([
        ("loop_run", (_args(same_images, checkpointEvery=1, name="mh"),
                      cwd)),
        ("loop_run", (_args(same_images, niter=1, name="mh1"), cwd)),
        ("hooked_train", (_args(same_images, name="hk"), cwd)),
    ],), device="cpu", timeout_s=WORLD_S)
    return runs, cwd


def test_two_rank_training_matches_single(same_images, two_rank_world):
    """Two gloo ranks train through the loop: identical replicas, rank 0
    alone writes the checkpoints, rank 1 logs to its own JSONL, and the
    result equals one process on the same data (a one-step run's
    gradients too)."""
    runs, cwd = two_rank_world
    tmp_path = pathlib.Path(cwd)
    outs = [r[0] for r in runs]
    assert [o["step"] for o in outs] == [2, 2]
    for k, v in outs[0]["gen"].items():
        np.testing.assert_array_equal(v, outs[1]["gen"][k], err_msg=k)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "mh_1_state.npz", "mh_2_state.npz"]
    assert (tmp_path / "logs" / "mh.jsonl").exists()
    assert (tmp_path / "logs" / "mh_p1.jsonl").exists()
    ref = _single(cwd, _args(same_images, name="mh_single"))
    got = _flat(outs[0]["gen"])
    want = _flat({k: v.numpy() for k, v in ref.gen.state_dict().items()})
    np.testing.assert_allclose(got, want, atol=LOOP_ATOL)
    one = _single(cwd, _args(same_images, niter=1, name="mh1_single"))
    check_gradients("the one-process run", runs[0][1]["mu"],
                    workers.adam_mu(one))


def test_epoch_hook_runs_on_every_rank_and_only_rank_0_prints(
        two_rank_world):
    """``train(epoch_hook=)`` on two ranks: the hook runs at each epoch
    boundary on both (its all_reduce returns, so both reached it), with
    the same step; rank 0 prints the loop's lines, rank 1 nothing."""
    runs, _ = two_rank_world
    hooked = [r[2] for r in runs]
    for h in hooked:
        assert h["seen"] == [(1, 1, 2), (2, 2, 4)], h["seen"]
    assert "Seed: 222" in hooked[0]["out"]
    assert "End of epoch 2 / 2" in hooked[0]["out"]
    assert hooked[1]["out"] == ""


def test_tp_checkpoint_loads_in_one_rank_and_in_jax(same_images, tmp_path):
    """modelParallel=2 over two ranks: the checkpoint rank 0 writes holds
    the gathered, single-device layout -- it restores into a one-process
    port state and into the JAX package's -- and autoResume continues the
    TP run from it."""
    cwd = str(tmp_path)
    args = _args(same_images, checkpointEvery=1, name="tp", modelParallel=2)
    outs = run_world(2, workers.many, ([
        ("loop_run", (args, cwd)),
        ("loop_run", ([*args, "niter=3", "autoResume=1"], cwd)),
    ],), device="cpu", timeout_s=WORLD_S)
    first = [o[0] for o in outs]
    assert [o["step"] for o in first] == [2, 2]
    assert [o[1]["step"] for o in outs] == [3, 3]
    path = str(tmp_path / "checkpoints" / "tp_2_state.npz")
    assert os.path.exists(path)
    state = tstep.init_train_state(Opt(device="cpu", **NET), "center",
                                   torch.Generator().manual_seed(1))
    ckpt.restore_checkpoint(path, state)
    assert state.step == 2
    for k, v in state.gen.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), first[0]["gen"][k],
                                      err_msg=k)
    jstate = jstep.init_train_state(jax.random.PRNGKey(1), JaxOpt(**NET),
                                    "center")
    jstate, _ = jax_restore(path, jstate)
    assert int(jstate.step) == 2
    sd_g, _ = convert.from_jax(jstate.params_g, jstate.state_g,
                               jstate.params_d, jstate.state_d)
    for k, v in sd_g.items():
        np.testing.assert_array_equal(v.numpy(), first[0]["gen"][k],
                                      err_msg=k)


def test_resume_desync_aborts_both_ranks(same_images, tmp_path):
    """autoResume with a checkpoint that only rank 0 sees (checkpointDir
    not shared) stops every rank with the evidence instead of training
    two desynchronised replicas."""
    dirs = {}
    for i in range(2):
        dirs[i] = str(tmp_path / f"p{i}")
        os.makedirs(dirs[i])
    outs = run_world(2, workers.save_then_loop,
                     (_args(same_images, autoResume=1, name="ds"), dirs,
                      dict(NET)), device="cpu", timeout_s=WORLD_S)
    for o in outs:
        assert "resume desync" in o["exit"], o
        assert "[1, -1]" in o["exit"] or "[1, 1]" not in o["exit"], o


@pytest.fixture(scope="module")
def distinct_images(tmp_path_factory):
    return _images(str(tmp_path_factory.mktemp("distinct") / "data"), True)


def test_two_rank_data_device_matches_single(distinct_images, tmp_path):
    """dataDevice over two ranks: each loads the corpus, they agree on its
    checksum, and each takes its rows of the global batch, a function of
    (seed, step): the run equals one process on distinct images (a
    one-step run's gradients too)."""
    cwd = str(tmp_path)
    args = _args(distinct_images, dataDevice=1, name="dd")
    runs = run_world(2, workers.many, ([
        ("loop_run", (args, cwd)),
        ("loop_run", (_args(distinct_images, dataDevice=1, niter=1,
                            name="dd1"), cwd)),
    ],), device="cpu", timeout_s=WORLD_S)
    outs = [r[0] for r in runs]
    for k, v in outs[0]["gen"].items():
        np.testing.assert_array_equal(v, outs[1]["gen"][k], err_msg=k)
    ref = _single(cwd, _args(distinct_images, dataDevice=1,
                             name="dd_single"))
    np.testing.assert_allclose(
        _flat(outs[0]["gen"]),
        _flat({k: v.numpy() for k, v in ref.gen.state_dict().items()}),
        atol=LOOP_ATOL)
    one = _single(cwd, _args(distinct_images, dataDevice=1, niter=1,
                             name="dd1_single"))
    check_gradients("the one-process run", runs[0][1]["mu"],
                    workers.adam_mu(one))


def test_data_device_corpus_checksums_must_agree(distinct_images, tmp_path):
    """Ranks whose decoded corpora differ all exit, naming each rank's
    checksum."""
    other = str(tmp_path / "other")
    shutil.copytree(os.path.join(distinct_images, "images"),
                    os.path.join(other, "images"))
    save_png(os.path.join(other, "images", "im_0000.png"),
             _texture(np.random.RandomState(9), 128, 128))
    args = _args(distinct_images, dataDevice=1, name="ck")
    outs = run_world(2, workers.loop_run,
                     (args, str(tmp_path), None,
                      {1: [f"DATA_ROOT={other}"]}),
                     device="cpu", timeout_s=WORLD_S)
    for o in outs:
        assert "checksums differ" in o["exit"], o


def test_mesh_plan_exits_naming_the_sizes():
    """The loop's mesh: every process a point of it, and a data axis that
    divides the batch."""
    opt = Opt(device="cpu", batchSize=6)
    assert loop.mesh_plan(opt, 2) == ("model", 2, 1)
    assert loop.mesh_plan(opt.replace(modelParallel=2), 2) == ("model", 1, 2)
    assert loop.mesh_plan(opt.replace(seqParallel=2, batchSize=4), 4) == \
        ("seq", 2, 2)
    with pytest.raises(SystemExit, match="must divide by the data axis 4"):
        loop.mesh_plan(opt, 4)
    with pytest.raises(SystemExit, match="world size is 4"):
        loop.mesh_plan(opt.replace(dataParallel=1), 4)


@pytest.mark.parametrize("mode,exc", [("die", RuntimeError),
                                      ("hang", TimeoutError)])
def test_a_dead_or_hung_rank_fails_within_the_timeout(mode, exc):
    """A rank that dies, or hangs while its peer waits in a collective,
    fails run_world within its timeout instead of hanging the caller.  The
    dead rank's world gets a time limit its two processes can start in on
    a loaded host (a rank takes seconds to import torch and join), so that
    its death, not the limit, ends it."""
    timeout_s = 60 if mode == "die" else 8
    t0 = time.monotonic()
    with pytest.raises(exc, match="rank 1|killed after"):
        run_world(2, workers.die_or_hang, (mode,), device="cpu",
                  timeout_s=timeout_s)
    assert time.monotonic() - t0 < 30


def test_dryrun_multichip(capsys):
    """The JAX dry run's counterpart on 4 gloo processes: every step
    variant on a data 2 x model 2 mesh, then the SP video3d step, each
    with finite metrics."""
    dryrun_multichip(4)
    out = capsys.readouterr().out
    for tag in ("dryrun_multichip ok: mesh=data:2xmodel:2",
                "dryrun withInit ok", "dryrun conditionAdv ok",
                "dryrun noiseGen ok", "dryrun wholeim ok",
                "dryrun SP ok: mesh=data:2xseq:2"):
        assert tag in out, out
