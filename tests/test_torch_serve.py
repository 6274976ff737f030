"""The port's inference server (video_filler_tpu_torch/serve.py): its device
function in every 2-D mode against the JAX package's ``serve_fn`` on the
same checkpoint and inputs, then the HTTP contracts on the port alone.

Tolerances: uint8 outputs within one level of the JAX server's (f32
convolutions summed in another order can round a pixel the other way), and
exactly equal to it outside the mask, where both return the input.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_eval import jax_checkpoint, opts
from video_filler_tpu.serve import InpaintServer as JaxServer
from video_filler_tpu_torch import serve
from video_filler_tpu_torch.checkpoint import ckpt
from video_filler_tpu_torch.serve import (
    InpaintServer,
    RequestTimeout,
    ServerOverloaded,
)
from video_filler_tpu_torch.train import step as tstep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FH, FW = 180, 240    # full frames: 2x2 tiles once padded, both top tiles


def _post(port, timeout=30, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://localhost:{port}/inpaint",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        with np.load(io.BytesIO(r.read()), allow_pickle=False) as data:
            return data["out"]


def _status(fn, *a, **kw):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*a, **kw)
    return e.value.code, e.value.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                timeout=10) as r:
        return r.read()


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    return {"center": jax_checkpoint(d, "center", "center", seed=0),
            "video": jax_checkpoint(d, "video", "video", seed=1),
            "wholeim": jax_checkpoint(d, "wholeim", "wholeim", seed=2),
            "init": jax_checkpoint(d, "init", "video", seed=3)}


def _box(shape, *boxes, value=1):
    m = np.zeros(shape + (1,), np.uint8)
    for y0, y1, x0, x1 in boxes:
        m[:, y0:y1, x0:x1] = value
    return m


MODES = {
    # name: (regime, options, ctx (B,H,W,C), mask (B,H,W,1), outside mask)
    "video_composite": ("video", {}, (2, 128, 128, 6),
                        lambda: _box((2, 128, 128), (40, 80, 30, 90),
                                     value=255)),
    "center_paste": ("center", {}, (2, 128, 128, 3),
                     lambda: np.ones((2, 128, 128, 1), np.uint8)),
    "wholeim_patch": ("wholeim", {}, (2, 128, 128, 27),
                      lambda: np.ones((2, 128, 128, 1), np.uint8)),
    "wholeim_frame": ("wholeim", dict(frameH=FH, frameW=FW, predLen=1),
                      (2, FH, FW, 3),
                      lambda: _box((2, FH, FW), (30, 60, 40, 80),
                                   (170, 178, 200, 230))),
    "video_frame": ("video", dict(frameH=FH, frameW=FW), (2, FH, FW, 6),
                    lambda: _box((2, FH, FW), (20, 70, 30, 90),
                                 (100, 150, 150, 230))),
    "video_frame_init": ("video", dict(frameH=FH, frameW=FW, withInit=True),
                         (2, FH, FW, 6),
                         lambda: _box((2, FH, FW), (20, 70, 30, 90))),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_function_matches_the_jax_server(nets, mode):
    regime, kw, shape, make_mask = MODES[mode]
    if kw.get("withInit"):
        kw = dict(kw, initName=nets["init"])
    jopt, popt = opts(regime, **kw)
    ctx = np.random.RandomState(5).randint(0, 256, shape, np.uint8)
    mask = make_mask()
    jsrv = JaxServer(jopt, regime, nets[regime], device_thread=False)
    try:
        ref = np.asarray(jsrv._serve_fn(
            jsrv._params, jsrv._bn, ctx, mask,
            np.zeros((2, 1, 1, jopt.nz), np.float32), *jsrv._extra_args))
    finally:
        jsrv.close()
    psrv = InpaintServer(popt, regime, nets[regime], device_thread=False)
    try:
        got = psrv._serve_fn(ctx, mask)
    finally:
        psrv.close()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1, f"{int((diff > 1).sum())} pixels beyond 1"
    if mode == "center_paste":
        outside = np.ones((128, 128), bool)
        outside[36:92, 36:92] = False          # the hole less the ring
        outside = np.broadcast_to(outside[None, ..., None], got.shape)
    elif mode == "wholeim_patch":
        outside = np.zeros(got.shape, bool)    # the raw G output
    else:
        outside = np.broadcast_to(mask == 0, got.shape)
    np.testing.assert_array_equal(got[outside], ref[outside])
    if outside.any():
        np.testing.assert_array_equal(got[outside], ctx[outside])
        assert not np.array_equal(got[~outside], ctx[~outside])


# --- HTTP, on the port alone ----------------------------------------------

@pytest.fixture(scope="module")
def video_ckpt(tmp_path_factory):
    """A checkpoint written by the port."""
    _, popt = opts("video", batchSize=4)
    state = tstep.init_train_state(popt, "video",
                                   torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in state.gen.parameters():
            p.mul_(2.0)
    return popt, ckpt.save_checkpoint(str(tmp_path_factory.mktemp("v")),
                                      "v", 1, state)


@pytest.fixture(scope="module")
def video_server(video_ckpt):
    popt, path = video_ckpt
    srv = InpaintServer(popt, "video", path, max_delay_ms=150.0)
    try:
        yield srv
    finally:
        srv.close()


def test_round_trip_composite_and_endpoints(video_server):
    srv = video_server
    ctx = np.random.RandomState(0).randint(0, 256, (128, 128, 6), np.uint8)
    raw = _post(srv.port, ctx=ctx)                 # no mask: all of G
    assert raw.shape == ctx.shape and raw.dtype == np.uint8
    assert not np.array_equal(raw, ctx)
    np.testing.assert_array_equal(
        _post(srv.port, ctx=ctx, mask=np.zeros((128, 128, 1), np.uint8)), ctx)
    mask = _box((1, 128, 128), (40, 80, 40, 80))[0]
    out = _post(srv.port, ctx=ctx, mask=mask)
    inside = mask[..., 0] == 1
    np.testing.assert_array_equal(out[~inside], ctx[~inside])
    np.testing.assert_array_equal(out[inside], raw[inside])
    np.testing.assert_array_equal(_post(srv.port, ctx=ctx, mask=mask * 255),
                                  out)         # 0/255 masks binarize alike
    assert _get(srv.port, "/healthz") == b"ok"
    s = json.loads(_get(srv.port, "/stats"))
    assert set(s) == {"requests", "items", "batches", "expired", "rejected",
                      "avg_fill", "p50_ms", "p95_ms"}
    assert s["requests"] >= 4 and 0 < s["avg_fill"] <= 1 and s["p50_ms"] > 0
    assert _status(_get, srv.port, "/nope")[0] == 404


def test_dynamic_batching_gives_each_row_its_own_result(video_server):
    srv = video_server
    rs = np.random.RandomState(1)
    ctxs = [rs.randint(0, 256, (128, 128, 6), np.uint8) for _ in range(8)]
    solo = [_post(srv.port, ctx=c) for c in ctxs]
    b0 = srv.stats()["batches"]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(lambda c: _post(srv.port, ctx=c), ctxs))
    for got, want in zip(outs, solo):       # BN in eval mode: the row's
        np.testing.assert_array_equal(got, want)  # place does not matter
    assert srv.stats()["batches"] - b0 < 8, "no batching happened"
    multi = _post(srv.port, ctx=np.stack(ctxs[:3]))
    np.testing.assert_array_equal(multi, np.stack(solo[:3]))


def test_client_errors_are_400(video_server, nets):
    srv = video_server
    rs = np.random.RandomState(2)
    ctx = rs.randint(0, 256, (128, 128, 6), np.uint8)
    bad = [dict(ctx=rs.randint(0, 256, (64, 64, 6), np.uint8)),
           dict(ctx=rs.randint(0, 256, (5, 128, 128, 6), np.uint8)),
           dict(ctx=ctx.astype(np.float32)),
           dict(ctx=ctx, mask=np.full((128, 128, 1), 0.7, np.float32)),
           dict(ctx=ctx, mask=np.zeros((64, 64, 1), np.uint8)),
           dict(ctx=ctx, noise=np.zeros(100, np.float32))]
    for arrays in bad:
        code, body = _status(_post, srv.port, **arrays)
        assert code == 400, (arrays.keys(), body)
    assert b"noiseGen=0" in body
    with pytest.raises(ValueError, match="ctx rows"):
        srv.infer(ctx[None, :64], None)
    _, popt = opts("center")
    center = InpaintServer(popt, "center", nets["center"], max_delay_ms=1.0)
    try:
        c3 = ctx[..., :3].copy()
        assert _post(center.port, ctx=c3).shape == (128, 128, 3)
        code, body = _status(_post, center.port, ctx=c3,
                             mask=np.ones((128, 128, 1), np.uint8))
        assert code == 400 and b"center" in body
    finally:
        center.close()


def test_overload_expiry_and_timeout(video_ckpt, monkeypatch):
    """No worker drains this server's queue, so the backlog stays put."""
    popt, path = video_ckpt
    srv = InpaintServer(popt, "video", path, max_delay_ms=1.0,
                        device_thread=False)
    try:
        one = np.zeros((1, 128, 128, 6), np.uint8)
        far = time.perf_counter() + 60.0
        while srv._pending_rows + 4 <= srv._max_pending_rows:
            srv._queue.put_nowait((np.zeros((4, 128, 128, 6), np.uint8),
                                   None, Future(), far))
            srv._pending_rows += 4
        with pytest.raises(ServerOverloaded, match="queue full"):
            srv.infer(one, None)
        code, body = _status(_post, srv.port, ctx=one[0])
        assert code == 503 and b"queue full" in body
        assert srv.stats()["rejected"] == 2
        before = srv._pending_rows
        assert srv._pop_live(0.5) is not None       # a pop frees its rows
        assert srv._pending_rows == before - 4
        while not srv._queue.empty():
            srv._queue.get_nowait()
        srv._pending_rows = 0
        stale, live = Future(), Future()
        srv._queue.put_nowait((one, None, stale, time.perf_counter() - 1.0))
        srv._queue.put_nowait((one, None, live, far))
        assert srv._pop_live(0.5)[2] is live        # the stale one dropped
        assert isinstance(stale.exception(timeout=0), TimeoutError)
        assert srv.stats()["expired"] == 1
        srv._pending_rows = 0
        monkeypatch.setattr(serve, "REQUEST_TIMEOUT_S", 0.05)
        with pytest.raises(RequestTimeout):
            srv.infer(one, None)
        code, _ = _status(_post, srv.port, ctx=one[0])
        assert code == 504
    finally:
        srv.close()


def test_carry_keeps_its_reservation_and_rechecks_its_deadline(video_ckpt):
    """A request that does not fit the batch being assembled heads the
    next one; held, it keeps its rows, and if it expires meanwhile it fails
    without a device batch."""
    popt, path = video_ckpt
    srv = InpaintServer(popt, "video", path, max_delay_ms=150.0)
    real_fn, permits, entered = srv._serve_fn, threading.Semaphore(0), []

    def gated_fn(*a):                  # each batch waits for a permit
        entered.append(1)
        assert permits.acquire(timeout=30)
        return real_fn(*a)

    def wait_until(cond):
        deadline = time.time() + 30
        while not cond() and time.time() < deadline:
            time.sleep(0.005)
        assert cond()

    srv._serve_fn = gated_fn
    try:
        futs = [Future() for _ in range(3)]
        srv._pending_rows += 9         # reserved as infer() would
        far = time.perf_counter() + 60
        srv._queue.put_nowait((np.zeros((4, 128, 128, 6), np.uint8), None,
                               futs[0], far))           # a full batch
        wait_until(lambda: len(entered) == 1)
        srv._queue.put_nowait((np.zeros((3, 128, 128, 6), np.uint8), None,
                               futs[1], far))
        expiry = time.perf_counter() + 0.3
        srv._queue.put_nowait((np.zeros((2, 128, 128, 6), np.uint8), None,
                               futs[2], expiry))        # 3 + 2 > 4: carry
        permits.release()              # the full batch runs
        assert futs[0].result(timeout=30).shape == (4, 128, 128, 6)
        wait_until(lambda: len(entered) == 2)   # the 3-row batch waits
        assert srv._pending_rows == 2  # the carry holds its rows
        wait_until(lambda: time.perf_counter() > expiry)
        permits.release()
        assert futs[1].result(timeout=30).shape == (3, 128, 128, 6)
        assert isinstance(futs[2].exception(timeout=30), TimeoutError)
        wait_until(lambda: srv._pending_rows == 0)
        s = srv.stats()
        assert s["expired"] == 1 and s["batches"] == 2 and s["items"] == 7
        assert len(entered) == 2       # no batch for the expired carry
    finally:
        for _ in range(3):
            permits.release()
        srv.close()


def test_warm_up_runs_on_the_thread_that_runs_the_batches(video_ckpt,
                                                         monkeypatch):
    """cuDNN keeps its timed plans per thread: the warm-up batch runs on
    the worker (or, without one, on the caller, who runs run_forever)
    before the constructor returns, and a failed warm-up raises there."""
    popt, path = video_ckpt
    calls, real_fn = [], InpaintServer._serve_fn

    def spy(self, ctx, mask):
        calls.append((threading.get_ident(), ctx.shape[0]))
        return real_fn(self, ctx, mask)

    monkeypatch.setattr(InpaintServer, "_serve_fn", spy)
    srv = InpaintServer(popt, "video", path, max_delay_ms=1.0)
    try:
        assert calls == [(srv._worker.ident, srv.batch)]
    finally:
        srv.close()
    srv = InpaintServer(popt, "video", path, device_thread=False)
    try:
        assert calls[1:] == [(threading.get_ident(), srv.batch)]
    finally:
        srv.close()

    def broken(self, ctx, mask):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(InpaintServer, "_serve_fn", broken)
    with pytest.raises(RuntimeError, match="out of memory"):
        InpaintServer(popt, "video", path)


def test_a_device_error_is_500_and_the_worker_lives(video_ckpt):
    popt, path = video_ckpt
    srv = InpaintServer(popt, "video", path, max_delay_ms=1.0)
    real_fn = srv._serve_fn
    calls = []

    def failing_once(*a):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA error: an illegal memory access")
        return real_fn(*a)

    srv._serve_fn = failing_once
    try:
        ctx = np.zeros((128, 128, 6), np.uint8)
        code, body = _status(_post, srv.port, ctx=ctx)
        assert code == 500 and b"illegal memory access" in body
        assert _post(srv.port, ctx=ctx).shape == ctx.shape
    finally:
        srv.close()


def test_drain_refuses_new_work_and_answers_the_backlog(video_ckpt):
    popt, path = video_ckpt
    srv = InpaintServer(popt, "video", path, max_delay_ms=1.0,
                        device_thread=False)
    try:
        one = np.zeros((1, 128, 128, 6), np.uint8)
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(srv.infer(one, None)))
            for _ in range(2)]
        for t in threads:
            t.start()
        deadline = time.time() + 10
        while srv._queue.qsize() < 2 and time.time() < deadline:
            time.sleep(0.01)
        srv.initiate_drain()
        with pytest.raises(ServerOverloaded, match="draining"):
            srv.infer(one, None)
        assert _status(_get, srv.port, "/healthz")[0] == 503
        assert _status(_post, srv.port, ctx=one[0])[0] == 503
        srv.run_forever()              # answers the backlog, then returns
        for t in threads:
            t.join(timeout=30)
        assert len(results) == 2 and results[0].shape == one.shape
    finally:
        srv.close()


def test_cli_serves_a_jax_checkpoint_and_drains_on_sigterm(nets, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    args = ["regime=video", "device=cpu", f"net={nets['video']}",
            "predLen=2", "batchSize=2", "nef=8", "ngf=8", "ndf=8",
            "nBottleneck=32", "computeDtype=float32", "display_port=0"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "video_filler_tpu_torch.serve", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=tmp_path)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving"), line + proc.stdout.read()
        port = int(line.split("http://localhost:")[1].split("/")[0])
        ctx = np.random.RandomState(3).randint(0, 256, (128, 128, 6),
                                               np.uint8)
        assert _post(port, ctx=ctx).shape == ctx.shape
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert "drained" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serving_and_metrics_import_no_jax():
    code = ("import sys\n"
            "import video_filler_tpu_torch.serve\n"
            "import video_filler_tpu_torch.eval.metrics\n"
            "import video_filler_tpu_torch.eval.stream\n"
            "import video_filler_tpu_torch.train.loop\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'video_filler_tpu.checkpoint')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


@pytest.mark.parametrize("kw,item", [
    (dict(regime="video3d", noiseGen=True), "video3d has neither"),
    (dict(dataParallel=3), "batchSize 4 must be divisible by "
                           "dataParallel 3")], ids=["video3d", "dataParallel"])
def test_unported_serving_options_exit_naming_their_item(video_ckpt, kw,
                                                         item):
    popt, path = video_ckpt
    regime = kw.get("regime", "video")
    options = {k: v for k, v in kw.items() if k != "regime"}
    with pytest.raises(SystemExit, match=item):
        InpaintServer(popt.replace(**options), regime, path)


def test_noise_gen_video_server_takes_noise_per_row(tmp_path):
    """A noiseGen video G served in patch mode: a row posted without noise
    equals a post of explicit zeros; posted noise reaches the output; two
    requests that share one padded batch, one with noise and one without,
    each get their solo result.  The full-frame mode refuses noiseGen."""
    _, popt = opts("video", batchSize=4, noiseGen=True, nz=5)
    state = tstep.init_train_state(popt, "video",
                                   torch.Generator().manual_seed(0))
    path = ckpt.save_checkpoint(str(tmp_path), "ng", 1, state)
    rs = np.random.RandomState(3)
    ctx = rs.randint(0, 256, (2, 128, 128, 6), np.uint8)
    z = rs.normal(size=(1, 1, 1, 5)).astype(np.float32) * 3
    srv = InpaintServer(popt, "video", path, max_delay_ms=1000.0)
    try:
        solo_z = _post(srv.port, ctx=ctx[0], noise=z[0, 0, 0])
        solo_0 = _post(srv.port, ctx=ctx[1])
        plain = _post(srv.port, ctx=ctx[0])
        zeros = _post(srv.port, ctx=ctx[1],
                      noise=np.zeros((1, 1, 5), np.float32))
        batches = srv.stats()["batches"]
        with ThreadPoolExecutor(2) as pool:
            a = pool.submit(srv.infer, ctx[:1], None, z)
            b = pool.submit(srv.infer, ctx[1:], None)
            got = a.result(), b.result()
        shared = srv.stats()["batches"] == batches + 1
    finally:
        srv.close()
    np.testing.assert_array_equal(solo_0, zeros)
    assert not np.array_equal(solo_z, plain)
    assert shared
    assert np.abs(got[0][0].astype(int) - solo_z.astype(int)).max() <= 1
    assert np.abs(got[1][0].astype(int) - solo_0.astype(int)).max() <= 1
    with pytest.raises(SystemExit, match="full-frame serving does not "
                                         "compose with noiseGen"):
        InpaintServer(popt.replace(frameH=FH, frameW=FW), "video", path)


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_replicas_equal_one_device(video_ckpt, n):
    """dataParallel=N with N CPU replicas (device=cpu): each padded batch
    runs as N row blocks, one thread per replica, joined in order -- a
    full batch, padded tails and 8 concurrent single-row posts give what
    dataParallel=1 gives."""
    popt, path = video_ckpt
    one = InpaintServer(popt, "video", path, max_delay_ms=50.0)
    srv = InpaintServer(popt.replace(dataParallel=n), "video", path,
                        max_delay_ms=50.0)
    try:
        assert [d.type for d in srv.devices] == ["cpu"] * n
        rs = np.random.RandomState(n)
        for rows in (4, 3, 1):       # batchSize 4: full, padded tails
            ctx = rs.randint(0, 256, (rows, 128, 128, 6), np.uint8)
            mask = _box((rows, 128, 128), (30, 90, 20, 100))
            np.testing.assert_array_equal(srv.infer(ctx, mask),
                                          one.infer(ctx, mask))
        ctxs = [rs.randint(0, 256, (128, 128, 6), np.uint8)
                for _ in range(8)]
        mask = _box((1, 128, 128), (40, 80, 40, 80))[0]
        with ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(lambda c: _post(srv.port, ctx=c, mask=mask),
                                 ctxs))
        for c, out in zip(ctxs, outs):
            np.testing.assert_array_equal(out,
                                          one.infer(c[None], mask[None])[0])
        assert srv.stats()["batches"] >= 2
    finally:
        srv.close()
        one.close()


def test_data_parallel_batch_must_divide_and_cards_must_exist(video_ckpt):
    """batchSize % N is refused with the JAX server's words; N above the
    card count exits naming it (checked through replica_devices, which the
    server calls first)."""
    popt, path = video_ckpt
    with pytest.raises(SystemExit, match="batchSize 4 must be divisible by "
                                         "dataParallel 3"):
        InpaintServer(popt.replace(dataParallel=3), "video", path)
    assert serve.replica_devices(popt, torch.device("cpu"), 4) == \
        [torch.device("cpu")]
    with pytest.raises(SystemExit, match="device_count"):
        serve.replica_devices(popt.replace(dataParallel=2),
                              torch.device("cuda"), 4)
