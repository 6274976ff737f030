"""The port's timing tools (video_filler_tpu_torch/bench.py and
scripts/bench_*.py) against the JAX package's bench.py and timing
scripts: each tool's configuration equals its JAX script's (read with
``ast``, or recorded from the script run at tiny width with its chip work
replaced); the bench's fused step, from JAX's initial state with JAX's
draws, equals one step of what bench.py's ``_time_step`` fuses; the
served device functions equal the JAX server's.

Tolerances: metrics rtol 1e-4 (tests/test_step_golden.py), parameters
after one Adam step atol 4.1e-3, each net's gradients as Adam first
moments within 0.1 of a leaf's largest value (tests/gradient_readings.py);
served uint8 frames within one level (tests/test_torch_serve.py).

Tiny widths, f32, one thread.  The JAX scripts are loaded from their files
as tests/test_torch_scripts.py loads them.
"""

import ast
import importlib.util
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import video_filler_tpu.train as jtrain
from test_torch_eval import opts
from test_torch_parallel import _jax_mu, check_gradients
from test_torch_serve import MODES, nets  # noqa: F401 -- a fixture
from test_torch_step import _allclose_trees, _port_tree
from _torch_workers import adam_mu
from video_filler_tpu.checkpoint import ckpt as jckpt
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.serve import InpaintServer as JaxServer
from video_filler_tpu_torch import bench
from video_filler_tpu_torch.checkpoint import convert
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import native
from video_filler_tpu_torch.scripts import (
    bench_e2e_datadevice as e2e,
    bench_loader,
    bench_serve_video_frame as serve_vf,
    bench_serve_wholeim as serve_wi,
)
from video_filler_tpu_torch.scripts.bisect_heldout_video import JaxDraws
from video_filler_tpu_torch.serve import InpaintServer
from video_filler_tpu_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "video_filler_tpu_torch")
CPU = torch.device("cpu")
BATCH = 4

torch.set_num_threads(1)


def _jax_file(rel, monkeypatch):
    """A JAX script loaded from its file (its argv emptied: the serving
    scripts read their batches from it at import)."""
    monkeypatch.setattr(sys, "argv", [rel])
    spec = importlib.util.spec_from_file_location(
        "jax_" + rel.replace("/", "_")[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return ast.parse(f.read())


def _eval(node, env):
    """A literal, a name of ``env``, ``a if SMOKE else b`` or ``dict(...)``
    of a script's text."""
    if isinstance(node, ast.IfExp):
        return _eval(node.body if _eval(node.test, env) else node.orelse, env)
    if isinstance(node, ast.Name):
        return env[node.id]
    if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "dict":
        return {k.arg: _eval(k.value, env) for k in node.keywords}
    return ast.literal_eval(node)


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.setenv("VF_SMOKE", "1")


# --- bench.py ---------------------------------------------------------------

def test_bench_configuration_and_line_are_bench_pys(smoke, capsys):
    """The Opt, the two batches, the baseline and the JSON line's keys of
    the JAX package's bench.py; the JSON line printed last; no TPU figure
    of bench.py in the port."""
    tree = _tree("bench.py")
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    opt = [n for n in calls if getattr(n.func, "id", "") == "Opt"]
    assert len(opt) == 1
    assert {k.arg: ast.literal_eval(k.value)
            for k in opt[0].keywords} == bench.OPT
    replace = [n for n in calls if getattr(n.func, "attr", "") == "replace"]
    assert [ast.literal_eval(k.value) for n in replace
            for k in n.keywords] == [bench.BATCHES[1]]
    assert bench.OPT["batchSize"] == bench.BATCHES[0] == 512
    consts = {n.targets[0].id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign)}
    assert consts["BASELINE_IMAGES_PER_SEC"] == bench.BASELINE_IMAGES_PER_SEC
    dumps = [n for n in calls if getattr(n.func, "attr", "") == "dumps"]
    keys = [ast.literal_eval(k) for k in dumps[0].args[0].keys]

    line = bench.main(["device=cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert list(line) == keys
    assert json.loads(out[-1]) == line
    assert out[0].startswith("device: cpu (host times")
    # on the CPU the device numbers are not measured
    assert line["hbm_gbps_achieved"] is None
    assert line["pct_of_streaming_roofline"] is None
    assert line["value"] > 0 and line["batch64_ms_per_step"] > 0
    for d, _, names in os.walk(PORT):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(d, name)) as f:
                    text = f.read()
                for tpu in ("552", "v5e", "STEP_UNIQUE_TRAFFIC"):
                    assert tpu not in text, (name, tpu)


def test_bench_step_equals_the_jax_fused_step(monkeypatch, tmp_path):
    """One step of bench.py's ``_time_step`` at tiny width (its jitted
    ``_fused`` recorded: JAX's initial state, the uint8 batch, the state
    and metrics after step seed 0) against the port's ``fused_step`` from
    that state with JAX's flips of seed 0."""
    jbench = _jax_file("bench.py", monkeypatch)
    kw = {**bench.OPT, **bench.SMOKE, "batchSize": BATCH}
    seen = {"calls": []}
    own_init, own_jit = jtrain.init_train_state, jax.jit

    def init(key, opt, regime):
        state = own_init(key, opt, regime)
        seen["init"] = jax.tree.map(np.array, state)   # before donation
        return state

    def jit(fn, **jkw):
        jitted = own_jit(fn, **jkw)
        if getattr(fn, "__name__", "") != "_fused":
            return jitted

        def call(state, raw, seed):
            out = jitted(state, raw, seed)
            seen["calls"].append((int(seed), np.array(raw),
                                  jax.tree.map(np.array, out)))
            return out
        return call
    monkeypatch.setattr(jtrain, "init_train_state", init)
    monkeypatch.setattr(jax, "jit", jit)
    jbench._time_step(JaxOpt(**kw), iters=1)
    seed, raw, (new, metrics) = seen["calls"][0]
    assert [c[0] for c in seen["calls"]] == [0, 1, 2, 100]
    init_state = seen["init"]

    opt = Opt(device="cpu", **kw)
    np.testing.assert_array_equal(bench.raw_batch(opt, CPU).numpy(), raw)
    state = tstep.init_train_state(opt, "center",
                                   torch.Generator().manual_seed(0))
    sd_g, sd_d = convert.from_jax(init_state.params_g, init_state.state_g,
                                  init_state.params_d, init_state.state_d)
    state.gen.load_state_dict(sd_g, strict=True)
    state.disc.load_state_dict(sd_d, strict=True)
    # JAX's draws of step seed 0: split(PRNGKey(0)) -> (k_prep, k_step),
    # split(k_prep) -> (k_crop, k_flip), the flips uniform(k_flip) < 0.5
    k_prep, _ = jax.random.split(jax.random.PRNGKey(seed))
    _, k_flip = jax.random.split(k_prep)
    flip = np.asarray(jax.random.uniform(k_flip, (BATCH,)) < 0.5)
    zeros = np.zeros((1, BATCH), np.int64)
    np.savez(tmp_path / "draws.npz", flip=flip[None], n_blocks=zeros,
             tly=zeros, tlx=zeros)
    draws = JaxDraws(str(tmp_path / "draws.npz"), tstep.center_draws)
    draws.step = 0
    monkeypatch.setattr(tstep, "center_draws", draws)
    got = bench.fused_step(opt)(state, torch.from_numpy(raw), seed)
    assert draws.step == 1 and flip.any() and not flip.all()

    for k in tstep.METRIC_KEYS:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    _allclose_trees(_port_tree(state.gen)[0], new.params_g, atol=4.1e-3)
    _allclose_trees(_port_tree(state.disc)[0], new.params_d, atol=4.1e-3)
    check_gradients("bench.py's fused step", adam_mu(state),
                    {"gen": _jax_mu(new.opt_g), "disc": _jax_mu(new.opt_d)})


@pytest.mark.parametrize("dtype,copy_bytes", [("float32", 0),
                                              ("bfloat16", 2)])
def test_step_bytes_is_the_hand_count(dtype, copy_bytes):
    """The byte count from the state's tensors after a step equals the
    count from the parameter shapes: 2 x (4 bytes for each weight,
    gradient and two moments, the compute copy of each conv weight, the
    activations) + the uint8 batch; a share over 100% raises."""
    opt = Opt(device="cpu", **{**bench.OPT, **bench.SMOKE,
                               "batchSize": BATCH, "computeDtype": dtype})
    state = tstep.init_train_state(opt, "center",
                                   torch.Generator().manual_seed(0))
    bench.fused_step(opt)(state, bench.raw_batch(opt, CPU), 0)
    shapes = [p.shape for net in (state.gen, state.disc)
              for _, p in net.named_parameters()]
    n = sum(int(np.prod(s)) for s in shapes)
    conv = sum(int(np.prod(s)) for s in shapes if len(s) == 4)
    assert conv < n
    act = 12345
    want = 2 * (16 * n + copy_bytes * conv + act) + BATCH * 128 * 128 * 3
    assert bench.step_bytes(state, opt, act) == want
    gbps, pct = bench.roofline(want, want / 3.35e9)   # exactly the peak
    assert pct == pytest.approx(100.0) and gbps == pytest.approx(3350.0)
    with pytest.raises(ValueError, match="byte count is wrong"):
        bench.roofline(want, want / 3.35e9 / 1.01)


# --- bench_e2e_datadevice -----------------------------------------------------

def _jax_e2e(smoke_mode):
    """FLAGSHIP and the run_leg calls of scripts/bench_e2e_datadevice.py
    with SMOKE set as given."""
    tree = _tree("scripts/bench_e2e_datadevice.py")
    env = {"SMOKE": smoke_mode}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            name = node.targets[0].id
            if name in ("N_IMAGES", "FLAGSHIP"):
                env[name] = _eval(node.value, env)
        elif isinstance(node, ast.If) and getattr(node.test, "id", "") == \
                "SMOKE" and smoke_mode:
            for call in (n for n in ast.walk(node) if isinstance(n, ast.Call)
                         and getattr(n.func, "attr", "") == "update"):
                env["FLAGSHIP"].update({k.arg: _eval(k.value, env)
                                        for k in call.keywords})
    calls = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", "") == "run_leg"),
                   key=lambda n: n.lineno)
    legs = [(*(_eval(a, env) for a in call.args),
             {k.arg: _eval(k.value, env) for k in call.keywords})
            for call in calls]
    return env["N_IMAGES"], env["FLAGSHIP"], legs


@pytest.mark.parametrize("smoke_mode", [False, True])
def test_e2e_legs_and_flagship_are_the_jax_scripts(smoke_mode):
    n, flagship, legs = _jax_e2e(smoke_mode)
    mine_n = e2e.SMOKE_IMAGES if smoke_mode else e2e.N_IMAGES
    assert mine_n == n
    assert {**e2e.flagship(n), **(e2e.SMOKE if smoke_mode else {})} == \
        flagship
    assert [(t, w, s, kw) for t, w, s, kw in
            (e2e.SMOKE_LEGS if smoke_mode else e2e.LEGS)] == legs


def test_e2e_rows_steps_and_a_flush_after_each_leg(smoke, monkeypatch,
                                                    tmp_path, capsys):
    """Under VF_SMOKE=1 on the CPU: one row per leg with the JAX fields,
    ``steps`` = timed epochs x N / batch, the results file holding every
    earlier row when a leg starts; the loop ran in ``work``."""
    on_disk = []
    own = e2e.run_leg

    def run_leg(*a, **kw):
        path = tmp_path / "w" / e2e.RESULTS
        on_disk.append(len(json.load(open(path))) if path.exists() else 0)
        return own(*a, **kw)
    monkeypatch.setattr(e2e, "run_leg", run_leg)
    rows = e2e.main(["device=cpu", f"work={tmp_path / 'w'}"])
    assert on_disk == [0, 1, 2]
    with open(tmp_path / "w" / e2e.RESULTS) as f:
        assert json.load(f) == rows
    fields = ["tag", "batch", "steps", "seconds", "ms_per_step",
              "clips_per_sec", "device"]
    assert all(list(r) == fields for r in rows)
    assert [(r["tag"], r["batch"], r["steps"]) for r in rows] == [
        (t, kw["batchSize"], timed * e2e.SMOKE_IMAGES // kw["batchSize"])
        for t, _, timed, kw in e2e.SMOKE_LEGS]
    assert all(r["seconds"] > 0 and np.isfinite(r["clips_per_sec"])
               for r in rows)
    assert os.path.exists(tmp_path / "w" / "logs" / "dd_e2e.jsonl")
    assert not os.path.exists(tmp_path / "w" / "checkpoints")
    assert capsys.readouterr().out.count("ROW ") == 3


# --- bench_loader -------------------------------------------------------------

def test_loader_rows_and_an_unavailable_native_decode(smoke, monkeypatch,
                                                      tmp_path, capsys):
    """A row per regime and decode path; where the native decode does not
    build, its row names the reason and nothing is timed under its
    label (the Python decode of the same regime is)."""
    args = ["device=cpu", "seconds=0.2", f"work={tmp_path}"]
    env_before = os.environ.get("VF_NO_NATIVE")
    rows = bench_loader.main(args)
    assert [(r["regime"], r["decode"]) for r in rows] == [
        ("video", "native C++"), ("video", "pure python"),
        ("wholeim", "native C++"), ("wholeim", "pure python")]
    for r in rows:
        assert ("unavailable" in r) != ("samples_per_sec" in r)
        if "samples_per_sec" in r:
            assert r["samples_per_sec"] > 0 and r["frames_per_sec_per_core"] > 0
    capsys.readouterr()
    timed = []
    own = bench_loader.time_loader
    monkeypatch.setattr(bench_loader, "time_loader", lambda opt, regime, s: (
        timed.append((regime, os.environ["VF_NO_NATIVE"])),
        own(opt, regime, s))[1])
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "unavailable_reason",
                        lambda: "g++: jpeglib.h: No such file")
    rows = bench_loader.main(args)
    out = capsys.readouterr().out
    assert timed == [("video", "1"), ("wholeim", "1")]
    for r in rows[::2]:
        assert r["unavailable"] == "g++: jpeglib.h: No such file"
        assert "samples_per_sec" not in r
    assert out.count("native C++: unavailable (g++: jpeglib.h") == 2
    assert os.environ.get("VF_NO_NATIVE") == env_before


# --- the serving tools ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["video_frame", "video_frame_init",
                                  "wholeim_frame"])
def test_timed_device_function_matches_the_jax_server(nets, mode):  # noqa: F811
    """One call of the function the serving tools time, on JAX's weights
    at a small frame, within one uint8 level of the JAX server's
    ``_serve_fn``; the chain feeds its output back unchanged in shape and
    dtype."""
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
        fn = psrv._device_fns[0]
        m = torch.from_numpy(mask)
        got = serve_vf.chain(fn, torch.from_numpy(ctx), m, 1)
        again = serve_vf.chain(fn, got, m, 2)
    finally:
        psrv.close()
    assert got.dtype == again.dtype == torch.uint8
    assert tuple(got.shape) == tuple(again.shape) == shape
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert diff.max() <= 1, f"{int((diff > 1).sum())} pixels beyond 1"


VIDEO_ROW = re.compile(r"ROW (\w+) batch=(\d+)( cascade)? ms/batch=[\d.]+ "
                       r"ms/clip=[\d.]+ ms/frame=[\d.]+ frames/s=\d+")
WHOLEIM_ROW = re.compile(r"ROW batch=(\d+) ms/batch=[\d.]+ ms/frame=[\d.]+ "
                         r"frames/s=\d+")


def _rows(out, pattern):
    lines = [ln for ln in out.splitlines() if ln.startswith("ROW")]
    found = [pattern.match(ln) for ln in lines]
    assert lines and all(found), lines
    return [f.groups() for f in found]


def _run_jax_serving_script(rel, monkeypatch, tmp_path, capsys):
    """The JAX serving script's main at tiny width on a 180x240 frame,
    batch 2, one timed call; returns (its default batches, the Opt
    keywords it wrote with its own frame size, its output)."""
    jscript = _jax_file(rel, monkeypatch)
    batches = list(jscript.batches)
    frame = dict(frameH=jscript.FRAME_H, frameW=jscript.FRAME_W)
    written = []

    def tiny_opt(**kw):
        written.append(dict(kw))
        return JaxOpt(**{**kw, **serve_vf.SMOKE})
    monkeypatch.setattr(jscript, "Opt", tiny_opt)
    monkeypatch.setattr(jscript, "FRAME_H", 180)
    monkeypatch.setattr(jscript, "FRAME_W", 240)
    monkeypatch.setattr(jscript, "batches", [2])
    monkeypatch.setattr(jscript, "save_checkpoint", lambda d, *a: (
        jckpt.save_checkpoint(str(tmp_path), *a)))
    if hasattr(jscript, "CKPT"):
        monkeypatch.setattr(jscript, "CKPT", str(tmp_path / "none.npz"))
    monkeypatch.setenv("BENCH_ITERS", "1")
    capsys.readouterr()
    jscript.main()
    return batches, {**written[0], **frame}, capsys.readouterr().out


def test_video_frame_tool_is_the_jax_scripts(smoke, monkeypatch, tmp_path,
                                             capsys):
    """The flagship Opt and batches of scripts/bench_serve_video_frame.py;
    the ROW lines in its format: plain at each batch, then the withInit
    cascade at the last."""
    batches, written, out = _run_jax_serving_script(
        "scripts/bench_serve_video_frame.py", monkeypatch, tmp_path, capsys)
    assert written == serve_vf.OPT
    assert tuple(batches) == serve_vf.BATCHES
    assert _rows(out, VIDEO_ROW) == [("plain", "2", None),
                                     ("withInit", "2", " cascade")]
    rows = serve_vf.main(["device=cpu", f"work={tmp_path}"])
    out = capsys.readouterr().out
    assert _rows(out, VIDEO_ROW) == [
        ("plain", "2", None), ("plain", "4", None),
        ("withInit", "4", " cascade")]
    # the device's busy time is traced on the card only
    assert [r["device_busy_ms_per_batch"] for r in rows] == [None] * 3
    assert "busy_ms/frame" not in out


def test_wholeim_tool_is_the_jax_scripts(smoke, monkeypatch, tmp_path,
                                         capsys):
    """The widths and batches of scripts/bench_serve_wholeim.py; the ROW
    lines in its format; without the ledger checkpoint a fresh init, said
    on a line."""
    batches, written, out = _run_jax_serving_script(
        "scripts/bench_serve_wholeim.py", monkeypatch, tmp_path, capsys)
    assert written == serve_wi.OPT
    assert tuple(batches) == serve_wi.BATCHES
    assert _rows(out, WHOLEIM_ROW) == [("2",)]
    assert serve_wi.ledger_checkpoint() == os.path.join(
        "ledgers", "lw_ledgers", "checkpoints", "lw_wi_final_999_state.npz")
    rows = serve_wi.main(["device=cpu", f"work={tmp_path}"])
    out = capsys.readouterr().out
    assert _rows(out, WHOLEIM_ROW) == [("2",), ("4",)]
    assert [r["device_busy_ms_per_batch"] for r in rows] == [None] * 2
    assert "busy_ms/frame" not in out
    assert "no ledger checkpoint; fresh init -> " in out
