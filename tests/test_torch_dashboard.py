"""The port's live dashboard (utils/dashboard.py, ``displayServer``) against
the JAX package's, and the trainer's ``profileSteps`` trace window."""

import glob
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from video_filler_tpu.utils.dashboard import Dashboard as JaxDashboard
from video_filler_tpu_torch.data.synthetic import make_image_folder
from video_filler_tpu_torch.train import loop
from video_filler_tpu_torch.utils import Dashboard, MetricsLogger, save_png

torch.set_num_threads(1)

TINY = ["regime=center", "device=cpu", "batchSize=2", "nef=8", "ngf=8",
        "ndf=8", "nBottleneck=16", "wtl2=0.999", "overlapPred=4",
        "computeDtype=float32", "niter=1", "nThreads=1", "loadSize=0",
        "checkpointEvery=5", "manualSeed=3", "display=0"]


def _get(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("dash")
    make_image_folder(str(d / "data"), n=14, h=140, w=150)
    return d


def test_dashboards_answer_alike(tmp_path, monkeypatch):
    """One logs/ + display/ tree behind both dashboards: the same JSON on
    /metrics?n=5 and /imgs, the same bytes on /img/<name>, the same page,
    and the same refusals."""
    monkeypatch.chdir(tmp_path)
    log = MetricsLogger("run", quiet=True)
    for step in range(8):
        log.log_step(1, step, 8, {"errD": 1.0 + step, "errG": 0.5,
                                  "errG_l2": 0.25 / (step + 1)}, 0.01, 0.002)
    log.log_epoch(1, 1, 1.5)
    log.close()
    rs = np.random.RandomState(0)
    for i, name in enumerate(("run_e1_s1_fake", "run_e1_s2_real",
                              "other_e1_s1_fake")):
        save_png(f"display/{name}.png",
                 rs.randint(0, 256, (6, 5, 3), np.uint8))
        os.utime(f"display/{name}.png", (1e9 + i, 1e9 + i))
    dashes = [JaxDashboard("run", port=0), Dashboard("run", port=0)]
    try:
        got = []
        for d in dashes:
            got.append({p: _get(d.port, p) for p in (
                "/metrics?n=5", "/imgs", "/img/run_e1_s2_real.png", "/")})
        assert got[0] == got[1]
        metrics = json.loads(got[1]["/metrics?n=5"][2])
        assert [r.get("step") for r in metrics] == [4, 5, 6, 7, None]
        assert json.loads(got[1]["/imgs"][2]) == ["run_e1_s2_real.png",
                                                  "run_e1_s1_fake.png"]
        for path, code in (("/img/missing.png", 404), ("/metrics?n=x", 400)):
            codes = []
            for d in dashes:
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(d.port, path)
                codes.append(e.value.code)
            assert codes == [code, code]
    finally:
        for d in dashes:
            d.close()


def test_display_server_serves_the_run_and_closes(data, monkeypatch):
    """displayServer=1 display_port=0 for a 2-step run: /metrics returns the
    run's logged steps while it trains (read as the loop closes it), and
    the port is closed after the run."""
    monkeypatch.chdir(data)
    seen = {}

    class Recording(Dashboard):
        def close(self):
            seen["port"] = self.port
            seen["metrics"] = json.loads(_get(self.port, "/metrics?n=10")[2])
            super().close()

    monkeypatch.setattr(loop, "Dashboard", Recording)
    loop.main([*TINY, "DATA_ROOT=data", "ntrain=4", "displayServer=1",
               "display_port=0", "name=dash"])
    assert [r["step"] for r in seen["metrics"] if "step" in r] == [0, 1]
    with pytest.raises(urllib.error.URLError):
        _get(seen["port"], "/metrics")


def _trace_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name") for e in events}


@pytest.mark.parametrize("steps,window,first", [(7, 2, 5), (3, 5, None),
                                                (7, 5, 5)],
                         ids=["inside", "never-reached", "cut-by-the-end"])
def test_profile_steps_trace_window(data, monkeypatch, steps, window, first):
    """profileSteps=N traces steps [5, 5+N): one Chrome trace under
    profileDir holding the step's ops.  A run that ends before step 5 starts
    none; one that ends inside the window stops it at its end.  Either way
    no profiler is left running."""
    monkeypatch.chdir(data)
    prof_dir = f"prof_{steps}_{window}"
    t0 = time.time()
    state = loop.main([*TINY, "DATA_ROOT=data", f"ntrain={2 * steps}",
                       f"profileSteps={window}", f"profileDir={prof_dir}",
                       f"name=prof{steps}_{window}"])
    assert state.step == steps
    assert not torch._C._autograd._profiler_enabled()
    traces = glob.glob(os.path.join(prof_dir, "*.json"))
    if first is None:
        assert traces == [] and not os.path.isdir(prof_dir)
        return
    assert traces == [os.path.join(prof_dir,
                                   f"prof{steps}_{window}_step{first}"
                                   ".pt.trace.json")]
    assert os.path.getmtime(traces[0]) >= t0 - 1
    names = _trace_names(traces[0])
    assert {"aten::convolution", "aten::convolution_backward"} <= names
