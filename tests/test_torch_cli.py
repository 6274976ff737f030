"""The port's trainer CLI, its refusals, and its independence from jax."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_filler_tpu_torch.config import Opt, resolve_device
from video_filler_tpu_torch.data.synthetic import make_image_folder
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


@pytest.mark.parametrize("arg,item", [
    ("regime=video", "A.7"), ("regime=video3d", "A.13"),
    ("dataDevice=1", "A.10"), ("modelParallel=2", "A.14"),
    ("noiseGen=1", "A.8"), ("gradAccum=2", "A.8"), ("withInit=1", "A.7"),
    ("autoResume=1", "A.6"), ("loadName=x", "A.6"), ("evalEvery=1", "A.9"),
    ("displayServer=1", "A.9"), ("profileSteps=3", "A.9"),
    ("checkpointEvery=1", "A.6"),
])
def test_unsupported_option_exits_naming_its_roadmap_item(arg, item):
    with pytest.raises(SystemExit, match=rf"ROADMAP {item}"):
        loop.main([*TINY, arg])


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
