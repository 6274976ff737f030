"""The port's trainer CLI: every 2-D regime, checkpoints and resume, its
refusals, and its independence from jax."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_filler_tpu_torch.config import Opt, resolve_device
from video_filler_tpu_torch.data.synthetic import (
    make_image_folder,
    make_mask_png,
    make_paired_folders,
    make_video_corpus,
)
from video_filler_tpu_torch.train import loop

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["regime=center", "device=cpu", "batchSize=2", "nef=8", "ngf=8",
        "ndf=8", "nBottleneck=16", "wtl2=0.999", "overlapPred=4",
        "computeDtype=float32", "niter=1", "ntrain=4", "nThreads=1",
        "loadSize=0", "checkpointEvery=2", "manualSeed=3"]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_cli_trains_two_steps(tmp_path):
    make_image_folder(str(tmp_path / "data"), n=8, h=140, w=150)
    proc = subprocess.run(
        [sys.executable, "-m", "video_filler_tpu_torch.train", *TINY,
         "DATA_ROOT=data", "display_iter=2", "name=cli"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Err_G_L2" in proc.stdout
    with open(tmp_path / "logs" / "cli.jsonl") as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "step" in r]
    assert [r["step"] for r in steps] == [0, 1]
    for r in steps:
        for k in ("errD", "errG", "errG_l2", "errG_total"):
            assert np.isfinite(r[k]), (k, r)
    assert any(r.get("epoch_end") == 1 for r in recs)
    for suffix in ("fake", "real", "inpaint"):
        assert (tmp_path / "display" / f"cli_e1_s2_{suffix}.png").exists()


@pytest.mark.parametrize("args,match", [
    (["seqParallel=2"], "ROADMAP A.14"),
    (["modelParallel=2"], "ROADMAP A.14"),
    # the JAX package's refusals of the ported dataDevice
    (["dataDevice=1", "display=1"], "incompatible with display=1"),
    (["dataDevice=1", "display=0", "seqParallel=2"],
     "dataDevice does not support seqParallel"),
    (["dataDevice=1", "display=0", "loadSize=-1"],
     "requires a deterministic loadSize"),
], ids=["seqParallel=2-A.14", "modelParallel=2-A.14", "dataDevice-display",
        "dataDevice-seqParallel", "dataDevice-loadSize"])
def test_unsupported_option_exits_naming_its_roadmap_item(args, match):
    """The multi-device options exit naming their ROADMAP item; dataDevice
    refuses what the JAX package refuses, before any resource exists."""
    with pytest.raises(SystemExit, match=match):
        loop.main([*TINY, *args])


SMALL = ["device=cpu", "batchSize=2", "nef=8", "ngf=8", "ndf=8",
         "nBottleneck=16", "wtl2=0.999", "computeDtype=float32", "ntrain=4",
         "nThreads=1", "display=0", "manualSeed=3"]
REGIME_ARGS = {
    "center": ["overlapPred=4", "loadSize=0", "DATA_ROOT=data"],
    "video": ["predLen=2", "weight_nomask=0.05", "loadSize=150",
              "DATA_ROOT=corpus", "maskName=mask.png"],
    "logo": ["loadSize=0", "DATA_ROOT=pairs/masked",
             "DATA_ROOT_GT=pairs/gt_pairs"],
    "wholeim": ["weight_nomask=0.05", "loadSize=150", "DATA_ROOT=corpus",
                "maskName=mask.png"],
}
VIDEO = ["regime=video", *SMALL, *REGIME_ARGS["video"]]


def _make_data(d):
    """The synthetic datasets REGIME_ARGS name, under ``d``."""
    make_image_folder(str(d / "data"), n=8, h=140, w=150)
    make_video_corpus(str(d / "corpus"), n_videos=2, frames=6, h=180, w=240)
    make_mask_png(str(d / "mask.png"), h=180, w=240)
    make_paired_folders(str(d / "pairs"), n=4, h=140, w=150)


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """A synthetic corpus and mask, and a one-epoch video checkpoint
    ``checkpoints/base_1_state.npz`` made by the CLI."""
    d = tmp_path_factory.mktemp("video_cli")
    _make_data(d)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        loop.main([*VIDEO, "niter=1", "checkpointEvery=1", "name=base"])
    finally:
        os.chdir(cwd)
    return d


def _steps(path):
    with open(path) as f:
        return [json.loads(line) for line in f if '"step"' in line]


# The options the port refused until it had the video regime and
# checkpoints, each now run: (extra arguments, what the run must show).
FORMERLY_REFUSED = {
    "regime=video": ([], "trains"),
    "withInit=1": (["withInit=1", "initName=checkpoints/base_1_state.npz",
                    "weight_nomask=0"], "trains"),
    "autoResume=1": (["autoResume=1", "name=base", "niter=2"], "resumes"),
    "loadName=x": (["loadName=base", "loadIter=1", "niter=2"], "resumes"),
    "checkpointEvery=1": (["checkpointEvery=1"], "checkpoints"),
    # the step options of ROADMAP A.8
    "noiseGen=1": (["noiseGen=1", "nz=5"], "trains"),
    "gradAccum=2": (["gradAccum=2", "batchSize=4", "ntrain=8"], "trains"),
    "remat=1": (["remat=1"], "trains"),
}


@pytest.mark.parametrize("case", list(FORMERLY_REFUSED))
def test_formerly_refused_option_now_runs(video_dir, monkeypatch, case):
    extra, shows = FORMERLY_REFUSED[case]
    monkeypatch.chdir(video_dir)
    name = case.split("=")[0]
    args = [*VIDEO, "niter=1", "checkpointEvery=5", f"name={name}", *extra]
    state = loop.main(args)
    log = f"logs/{'base' if 'name=base' in extra else name}.jsonl"
    steps = _steps(log)
    assert steps and all(np.isfinite(r["errG_l2"]) for r in steps)
    if shows == "resumes":
        assert state.step == 4 and steps[-1]["epoch"] == 2
    else:
        assert state.step == 2
    if shows == "checkpoints":
        assert os.path.exists(f"checkpoints/{name}_1_state.npz")


@pytest.mark.parametrize("regime", ["center", "video", "logo", "wholeim"])
def test_cli_checkpoints_and_auto_resumes_every_regime(tmp_path, regime):
    """Two CLI processes: one epoch with a checkpoint, then autoResume to
    epoch 2; the second run's steps are logged under epoch 2."""
    _make_data(tmp_path)
    for niter in (1, 2):
        proc = subprocess.run(
            [sys.executable, "-m", "video_filler_tpu_torch.train",
             f"regime={regime}", *SMALL, *REGIME_ARGS[regime],
             f"niter={niter}", "checkpointEvery=1", "autoResume=1",
             "name=r"],
            cwd=tmp_path, env=_env(), capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr
    assert "auto-resumed r at epoch 1" in proc.stdout
    steps = _steps(tmp_path / "logs" / "r.jsonl")
    assert [r["epoch"] for r in steps] == [1, 1, 2, 2]
    assert all(np.isfinite(r["errG_total"]) for r in steps)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == \
        ["r_1_state.npz", "r_2_state.npz"]


def test_port_imports_with_jax_blocked():
    """Every module of the port (and chip_smoke.py) imports in a process in
    which importing jax raises."""
    code = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"jax is blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import video_filler_tpu_torch as pkg
prefix = pkg.__name__ + "."
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, prefix)]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def test_device_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(Opt(device="cuda"))
    assert resolve_device(Opt(device="cpu")) == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda_or_outside_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                           env=_env(), capture_output=True, text=True,
                           timeout=300)]
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    runs.append(subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                               env=_env(), capture_output=True, text=True,
                               timeout=300))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
