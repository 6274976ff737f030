"""The port's programmatic loop API (``train(max_steps=, quiet=,
epoch_hook=)``) and its ledgers (video_filler_tpu_torch/ledger/) against
the JAX package's loop and scripts/ledger_common.py.

Tiny widths (nef=ngf=ndf=8), f32, one thread.  The loop cases compare
what both packages do with one configuration: where they stop, what the
hook sees and when, what they print.  The ledger cases compare the rows'
schema, tags and flushes with the JAX ledger's; one checkpoint the port's
ledger wrote is scored by both packages with the JAX side's eval draws
(tests/test_torch_eval.py's tolerance: rtol 1e-5, each std within 1e-5 of
its mean).  The presets are held to the scripts' text, read with ``ast``:
importing a script trains a model.
"""

import ast
import glob
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_eval import jax_draws
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.eval import metrics as jmetrics
from video_filler_tpu.train.loop import train as jax_train
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import synthetic
from video_filler_tpu_torch.eval import metrics
from video_filler_tpu_torch.ledger import common, presets
from video_filler_tpu_torch.ledger.compare import align_tags, compare
from video_filler_tpu_torch.ledger.__main__ import main as ledger_main
from video_filler_tpu_torch.ledger.keepbest import run_keepbest
from video_filler_tpu_torch.ledger.rescore import rescore
from video_filler_tpu_torch.train.loop import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")

torch.set_num_threads(1)

TINY = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, batchSize=2, nThreads=0,
            computeDtype="float32", niter=1, ntrain=8, manualSeed=222,
            display=False, checkpointEvery=1, loadSize=140, wtl2=0.999)
# the JAX ledger's row schema (scripts/ledger_common.py _score)
ROW_KEYS = ["regime", "ckpt", "evalSplit", "l2", "psnr_db", "ssim",
            "hole_l2", "l2_std", "psnr_db_std", "ssim_std", "hole_l2_std",
            "n_batches", "batchSize"]


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """Six images: 3 steps per epoch at batch 2 (ntrain 8 clamped to 6)."""
    return synthetic.make_image_folder(str(tmp_path_factory.mktemp("imgs")),
                                       n=6)


def _both(image_root, **kw):
    kw = {**TINY, "DATA_ROOT": image_root, **kw}
    return JaxOpt(**kw), Opt(device="cpu", **kw)


def _hook(seen):
    def hook(epoch, state):
        g = state.params_g if hasattr(state, "params_g") else None
        if g is None:      # the port's state: G's first parameter
            first = next(state.gen.parameters()).detach().numpy()
        else:
            first = np.asarray(jax.device_get(jax.tree.leaves(g)[0]))
        seen.append((epoch, int(state.step), bool(np.isfinite(first).all())))
    return hook


# --- the loop: max_steps, quiet, epoch_hook ---------------------------------

@pytest.mark.parametrize("max_steps,niter,want_hooks", [
    (2, 2, []),
    (6, 3, [(1, 3, True)]),
], ids=["max_steps_2", "max_steps_6_stops_before_epoch_2s_hook"])
def test_max_steps_stops_where_jax_stops(image_root, tmp_path, monkeypatch,
                                         capsys, max_steps, niter,
                                         want_hooks):
    """(1) and (3): the run ends after ``max_steps`` optimizer steps of the
    call, at the step's end; a stop inside (or at the last step of) an
    epoch skips that epoch's log, hook and checkpoint.  ``quiet`` prints
    nothing."""
    jopt, popt = _both(image_root, niter=niter, name="ms")
    results = {}
    for pkg, fn, opt in (("jax", jax_train, jopt), ("port", train, popt)):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        seen = []
        capsys.readouterr()
        state = fn(opt, "center", max_steps=max_steps, quiet=True,
                   epoch_hook=_hook(seen))
        results[pkg] = (int(state.step), seen,
                        sorted(os.listdir("checkpoints"))
                        if os.path.isdir("checkpoints") else [])
        assert capsys.readouterr().out == "", pkg
        with open("logs/ms.jsonl") as f:
            ends = [json.loads(x)["epoch_end"] for x in f if "epoch_end" in x]
        assert ends == [e for e, _, _ in want_hooks], pkg
    want_ckpts = [f"ms_{e}_state.npz" for e, _, _ in want_hooks]
    assert results["port"] == results["jax"] == (max_steps, want_hooks,
                                                 want_ckpts)


def test_epoch_hook_sees_live_state(image_root, tmp_path, monkeypatch):
    """(2): the hook runs at every completed epoch boundary with the live
    state (the JAX case is tests/test_e2e_train.py
    test_epoch_hook_sees_live_state), and the loop's state after it is
    the one the hook saw, G in training mode."""
    jopt, popt = _both(image_root, niter=2, checkpointEvery=9999,
                       name="hooked")
    monkeypatch.chdir(tmp_path)
    jseen, seen, modes = [], [], []
    jax_train(jopt, "center", quiet=True, epoch_hook=_hook(jseen))

    def hook(epoch, st):
        _hook(seen)(epoch, st)
        modes.append(st.gen.training)
    state = train(popt, "center", quiet=True, epoch_hook=hook)
    assert seen == jseen == [(1, 3, True), (2, 6, True)]
    assert modes == [True, True] and state.gen.training


def test_eval_event_comes_before_the_users_hook(image_root, tmp_path,
                                                monkeypatch):
    """(4): with evalEvery the in-train eval (and keepBest) runs first at
    the boundary and the user's hook after it, in both packages: the hook
    finds the epoch's eval record in the JSONL."""
    found = {}
    for pkg, fn in (("jax", jax_train), ("port", train)):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        jopt, popt = _both(image_root, niter=2, checkpointEvery=9999,
                           evalEvery=1, evalBatches=1, keepBest=True,
                           name="ev")
        seen = []

        def hook(epoch, st):
            with open("logs/ev.jsonl") as f:
                recs = [json.loads(x) for x in f]
            seen.append((epoch, [r["eval_epoch"] for r in recs
                                 if "eval_epoch" in r],
                         os.path.exists("checkpoints/ev_best_state.npz")))
        fn(jopt if pkg == "jax" else popt, "center", quiet=True,
           epoch_hook=hook)
        found[pkg] = seen
    assert found["port"] == found["jax"] == [(1, [1], True),
                                             (2, [1, 2], True)]


def test_default_call_prints_and_quiet_silences_the_log(image_root, tmp_path,
                                                        monkeypatch, capsys):
    """``quiet=False`` keeps the loop's prints (the CLI's behaviour);
    ``quiet=True`` silences them, and the JSONL is written either way."""
    monkeypatch.chdir(tmp_path)
    _, popt = _both(image_root, name="loud")
    train(popt, "center", max_steps=1)
    out = capsys.readouterr().out
    assert "Seed: 222" in out and "Epoch: [1]" in out
    train(popt.replace(name="hush"), "center", max_steps=1, quiet=True)
    assert capsys.readouterr().out == ""
    assert os.path.exists("logs/hush.jsonl")


# --- the ledger protocol ---------------------------------------------------

def _jax_ledger():
    sys.path.insert(0, SCRIPTS)
    try:
        from ledger_common import run_ledger
    finally:
        sys.path.remove(SCRIPTS)
    return run_ledger


def test_save_free_ledger_matches_jax(image_root, tmp_path, monkeypatch,
                                      capsys):
    """(5): run_ledger(save=False, score_every=1) gives the JAX ledger's
    row schema, tags and flushes on one configuration (3 steps per epoch;
    max_steps=6 stops inside epoch 2, so one periodic row; the final row
    is tagged by the step reached, not by the hand-written final_tag), and
    writes no checkpoint."""
    got = {}
    for pkg, fn in (("jax", _jax_ledger()), ("port", common.run_ledger)):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        jopt, popt = _both(image_root, niter=2, checkpointEvery=9999,
                           name="nosave")
        rows, flushed = [], []
        fn(jopt if pkg == "jax" else popt, "center", ("train",),
           rows, mid_tag="mid", final_tag="final", max_steps=6, n_batches=1,
           save=False, score_every=1,
           flush=lambda rows=rows, flushed=flushed: flushed.append(len(rows)))
        out = capsys.readouterr().out
        assert "final_tag final != actual step6" in out, pkg
        assert out.count("ROW ") == 3, pkg
        assert not glob.glob("checkpoints/*"), pkg
        assert all(np.isfinite(r["hole_l2"]) for r in rows), pkg
        got[pkg] = ([list(r) for r in rows],
                    [(r["ckpt"], r["evalSplit"]) for r in rows], flushed)
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == ROW_KEYS
    assert got["port"][1] == [("init", "train"), ("step3", "train"),
                              ("step6", "train")]
    assert got["port"][2] == [1, 2, 3]


SMALL = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, computeDtype="float32",
             batchSize=2, nThreads=0, niter=2, checkpointEvery=1,
             device="cpu")


@pytest.fixture(scope="module")
def ledger_dir(tmp_path_factory):
    """A work directory as the heldout preset's center run leaves it, at
    tiny width: 10 images (split 80: 8 to train on, 4 steps per epoch),
    2 epochs, a checkpoint each; (rows, flush counts, directory)."""
    d = tmp_path_factory.mktemp("ledger")
    synthetic.make_image_folder(str(d / "images"), n=10, h=160, w=200,
                                seed=0)
    opt = Opt(**{**presets.PRESETS["heldout"].runs["center"].opt, **SMALL})
    rows, flushed = [], []
    cwd = os.getcwd()
    os.chdir(d)
    try:
        common.run_ledger(opt, "center", ("train", "test"), rows,
                          mid_tag="step4", final_tag="step8", n_batches=2,
                          flush=lambda: flushed.append(len(rows)))
    finally:
        os.chdir(cwd)
    return rows, flushed, d


def test_saving_ledger_writes_and_scores_three_checkpoints(ledger_dir,
                                                           monkeypatch):
    """(6): init, mid and final files in the loop's layout (the JAX
    package's format), each scored on both splits; the final file scored
    by the port with the JAX side's draws equals the JAX package's score
    of it; the ledger's own row equals a fresh ``evaluate`` of it."""
    rows, flushed, d = ledger_dir
    assert [(r["ckpt"], r["evalSplit"]) for r in rows] == [
        (t, s) for t in ("init", "step4", "step8") for s in ("train", "test")]
    assert all(list(r) == ROW_KEYS for r in rows)
    assert flushed == [1, 2, 3, 4, 5, 6]
    files = sorted(os.listdir(d / "checkpoints"))
    assert files == ["hc_1_state.npz", "hc_2_state.npz",
                     "hc_init_0_state.npz"]
    steps = {f: int(np.load(d / "checkpoints" / f)[".step"]) for f in files}
    assert steps == {"hc_1_state.npz": 4, "hc_2_state.npz": 8,
                     "hc_init_0_state.npz": 0}
    path = str(d / "checkpoints" / "hc_2_state.npz")
    kw = {**presets.PRESETS["heldout"].runs["center"].opt, **SMALL}
    kw.pop("device")
    monkeypatch.chdir(d)
    jopt = JaxOpt(**kw, net=path, evalSplit="test")
    popt = Opt(**kw, net=path, evalSplit="test", device="cpu")
    ref = jmetrics.evaluate(jopt, "center", n_batches=2, seed=5)
    key, draws = jax.random.PRNGKey(5), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(jax_draws("center", sub, 2))
    got = metrics.evaluate(popt, "center", n_batches=2, seed=5, draws=draws)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.endswith("_std"):
            np.testing.assert_allclose(got[k], v, rtol=0,
                                       atol=1e-5 * abs(ref[k[:-4]]),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    mine = metrics.evaluate(popt, "center", n_batches=2)
    assert rows[-1] == {"regime": "center", "ckpt": "step8",
                        "evalSplit": "test",
                        **{k: round(float(v), 4) for k, v in mine.items()}}


def test_saving_ledger_tags_the_final_row_by_the_step_reached(
        image_root, tmp_path, monkeypatch, capsys):
    """A run that ends before its last epoch (here ``max_steps``; a SIGTERM
    likewise) writes its final state as ``<name>_final_999`` and tags its
    row with the step reached, not the caller's final_tag: a save=True
    ledger cut short must not label a step-4 state "step3000"."""
    monkeypatch.chdir(tmp_path)
    _, popt = _both(image_root, niter=1000, checkpointEvery=267,
                    name="cut")
    rows = []
    common.run_ledger(popt, "center", ("train",), rows, mid_tag="step801",
                      final_tag="step3000", max_steps=4, n_batches=1)
    assert "final_tag step3000 != actual step4" in capsys.readouterr().out
    assert [r["ckpt"] for r in rows] == ["init", "step4"]
    assert sorted(os.listdir("checkpoints")) == [
        "cut_final_999_state.npz", "cut_init_0_state.npz"]


def test_rescore_reproduces_the_ledger_rows(ledger_dir):
    """(10): re-scoring the work directory finds the run's three files by
    the preset's run name, tags them by their stored step, and gives the
    ledger's rows again (the same files, the same seeded eval stream)."""
    rows, _, d = ledger_dir
    again = rescore(str(d), SMALL, n_batches=2)
    assert [{**r, "ledger": "hc"} for r in rows] == again
    with open(d / "rescore_results.json") as f:
        assert json.load(f) == again
    # the command line, options and directories in any order
    ledger_main(["rescore", "--device", "cpu", "nef=8", "ngf=8", "ndf=8",
                 str(d), "nBottleneck=32", "computeDtype=float32",
                 "batchSize=2", "niter=2", "checkpointEvery=1",
                 "--n-batches", "2"])
    with open(d / "rescore_results.json") as f:
        assert json.load(f) == again
    assert os.path.exists(d / "rescore_results.json.prev1")


def test_json_flusher_backs_up_partial_curves(tmp_path, monkeypatch):
    """(7), the port of tests/test_scripts.py's case: a retry never loses
    a longer partial curve of an earlier attempt."""
    monkeypatch.chdir(tmp_path)
    first = [{"ckpt": "init"}, {"ckpt": "mid"}]
    common.json_flusher("r.json", first)()
    common.json_flusher("r.json", [])        # a retry dead before a row
    assert json.load(open("r.json")) == first
    assert json.load(open("r.json.prev1")) == first
    retry = [{"ckpt": "init"}]
    common.json_flusher("r.json", retry)()
    assert json.load(open("r.json")) == retry
    assert json.load(open("r.json.prev2")) == first


def test_keepbest_checks_hold_at_tiny_width(ledger_dir, monkeypatch, capsys):
    """(9): the keepBest demo's three checks on its preset at tiny width
    (dataDevice on the CPU, an eval on the held-out split every epoch)."""
    _, _, d = ledger_dir
    monkeypatch.chdir(d)
    opt = Opt(**{**presets.KEEPBEST.runs["center"].opt, **SMALL,
                 "niter": 4, "checkpointEvery": 9999, "evalEvery": 1,
                 "evalBatches": 1})
    rows = []
    res = run_keepbest(opt, "center", rows)
    out = capsys.readouterr().out
    assert "CHECK1 ok" in out and "CHECK2 ok" in out and "CHECK3:" in out
    assert res["evals"] == 4
    assert res["meta"]["hole_l2"] == pytest.approx(res["curve_best"],
                                                   abs=1e-4)
    assert res["rescored"] == pytest.approx(res["meta"]["hole_l2"],
                                            abs=5e-4)
    assert [r["ckpt"] for r in rows] == ["step4", "step8", "step12",
                                         "step16", "best-rescored",
                                         "final-vs-best"]


def test_cli_runs_a_preset_at_tiny_width(tmp_path, capsys):
    """``python -m video_filler_tpu_torch.ledger``: a preset run with
    options over it builds its corpus in the work directory, writes its
    result file there, and every row names the options (a key=value after
    ``--regimes`` is an option, not a run)."""
    d = str(tmp_path / "w")
    ledger_main(["center_soak256fine", "--workdir", d, "--device", "cpu",
                 "--max-steps", "3", "--n-batches", "1", "nef=8", "ngf=8",
                 "ndf=8", "nBottleneck=32", "batchSize=2", "nThreads=0",
                 "--regimes", "center", "computeDtype=float32",
                 "manualSeed=223"])
    assert os.path.isdir(os.path.join(d, "images"))
    with open(os.path.join(d, "center_soak256fine_results.json")) as f:
        rows = json.load(f)
    assert [r["ckpt"] for r in rows] == ["init", "init", "step3", "step3"]
    assert all(r["max_steps"] == 3 and r["nef"] == 8 and
               r["manualSeed"] == 223 for r in rows)
    out = capsys.readouterr().out
    assert "LEDGER center_soak256fine center:" in out and "Seed: 223" in out


def test_compare_holds_rows_to_the_limits(tmp_path, capsys):
    """``compare``: rows matched by (regime, ckpt, split), hole-L2 as a
    share of the reference's, PSNR as a difference; init within 10%, the
    final row within 20% and 1.0 dB, mid rows without a limit."""
    def row(ckpt, split, hole, psnr):
        return {"regime": "center", "ckpt": ckpt, "evalSplit": split,
                "hole_l2": hole, "hole_l2_std": 0.001, "psnr_db": psnr}
    ref = [row("init", "train", 0.25, 19.0), row("step801", "train", 0.1,
                                                 22.0),
           row("step3000", "train", 0.010, 31.0),
           row("step3000", "test", 0.100, 22.0)]
    got = [row("init", "train", 0.276, 19.1), row("step801", "train", 0.2,
                                                  20.0),
           row("step3000", "train", 0.0119, 31.9),
           row("step3000", "test", 0.100, 20.9)]
    entries = compare(ref, got, {"center": "step3000"})
    assert [e[4] for e in entries] == ["miss", "", "ok", "miss"]
    assert entries[0][2] == pytest.approx(0.104)
    assert entries[3][3] == pytest.approx(-1.1)
    for name, rows in (("ref.json", ref), ("run.json", got)):
        with open(tmp_path / name, "w") as f:
            json.dump(rows, f)
    ledger_main(["compare", str(tmp_path / "ref.json"),
                 str(tmp_path / "run.json")])
    out = capsys.readouterr().out
    assert ("| center | step3000 | test |  | 0.1000 ± 0.0010 | 0.1000 ± "
            "0.0010 | +0.0% | 22.00 | 20.90 | -1.10 | miss |") in out


def test_compare_aligns_the_scripts_tags_by_position(tmp_path, capsys):
    """The JAX scripts tag some ledgers ``mid`` / ``final`` (condadv) or
    ``step800`` (the re-scored noisegen rows) where the port tags the step
    reached: a regime with as many tags on both sides is matched by
    position, the run's tag kept as ``run_ckpt``; a regime whose tags
    already agree, or whose counts differ, is left as it is."""
    def row(regime, ckpt, hole=0.1):
        return {"regime": regime, "ckpt": ckpt, "evalSplit": "train",
                "hole_l2": hole, "hole_l2_std": 0.001, "psnr_db": 20.0}
    ref = [row("center", t) for t in ("init", "mid", "final")] + \
        [row("logo", t) for t in ("init", "step800", "step3000")]
    got = [row("center", t) for t in ("init", "step801", "step3000")] + \
        [row("logo", t) for t in ("init", "step800", "step3000")] + \
        [row("video", "init")]
    aligned = align_tags(ref, got)
    assert [(r["regime"], r["ckpt"], r.get("run_ckpt")) for r in aligned] \
        == [("center", "init", None), ("center", "mid", "step801"),
            ("center", "final", "step3000"), ("logo", "init", None),
            ("logo", "step800", None), ("logo", "step3000", None),
            ("video", "init", None)]
    assert got[2]["ckpt"] == "step3000"          # the input is not changed
    for name, rows in (("ref.json", ref), ("run.json", got)):
        with open(tmp_path / name, "w") as f:
            json.dump(rows, f)
    ledger_main(["compare", str(tmp_path / "ref.json"),
                 str(tmp_path / "run.json")])
    out = capsys.readouterr().out
    assert "| center | final | train | run_ckpt=step3000 |" in out
    assert out.count("| ok |") == 4              # init and final, twice
    # a reference scored before the std columns existed (round-3 files)
    for r in ref:
        del r["hole_l2_std"]
    with open(tmp_path / "ref.json", "w") as f:
        json.dump(ref, f)
    ledger_main(["compare", str(tmp_path / "ref.json"),
                 str(tmp_path / "run.json")])
    assert ("| logo | step3000 | train |  | 0.1000 | 0.1000 ± 0.0010 |"
            in capsys.readouterr().out)


# --- the presets against the scripts' text ----------------------------------

def _value(node, env):
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("dict", "Opt"):
        out = {}
        for kw in node.keywords:
            if kw.arg is None:
                out.update(_value(kw.value, env))
            else:
                out[kw.arg] = _value(kw.value, env)
        return out
    if isinstance(node, ast.Name) and node.id in env:
        return env[node.id]
    return ast.literal_eval(node)


def script_config(rel: str) -> dict:
    """A script's WORK, synthetic corpora, result file and run_ledger
    calls (or its local ``run(regime, Opt(...), spe=, splits=)`` helper's
    calls, whose tags are ``step{checkpointEvery*spe}`` and
    ``step{niter*spe}``), read from its text."""
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read())
    env, helper = {}, None
    skip = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            helper = node.name
            skip |= {id(n) for n in ast.walk(node)}
    calls = sorted((n for n in ast.walk(tree)
                    if isinstance(n, (ast.Call, ast.Assign))
                    and id(n) not in skip),
                   key=lambda n: (n.lineno, n.col_offset))
    cfg = {"corpora": [], "runs": [], "results": None, "opt": None}
    for n in calls:
        if isinstance(n, ast.Assign):
            if len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                try:
                    env[n.targets[0].id] = _value(n.value, env)
                except (ValueError, TypeError):
                    pass
            continue
        f = n.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", None)
        if isinstance(f, ast.Attribute) and getattr(f.value, "id", "") == \
                "synthetic":
            cfg["corpora"].append(
                (name, tuple(ast.literal_eval(a) for a in n.args),
                 {k.arg: ast.literal_eval(k.value) for k in n.keywords}))
        elif name == "json_flusher" and isinstance(n.args[0], ast.Constant):
            cfg["results"] = n.args[0].value
        elif name == "Opt" and cfg["opt"] is None:
            cfg["opt"] = _value(n, env)
        elif name == "run_ledger":
            kw = {k.arg: ast.literal_eval(k.value) for k in n.keywords
                  if k.arg != "flush"}
            cfg["runs"].append(dict(
                regime=ast.literal_eval(n.args[1]),
                opt=_value(n.args[0], env),
                splits=ast.literal_eval(n.args[2]),
                mid_tag=kw.pop("mid_tag"), final_tag=kw.pop("final_tag"),
                ledger=kw))
        elif name == helper and name == "run":
            kw = {k.arg: _value(k.value, env) for k in n.keywords}
            opt = _value(n.args[1], env)
            spe = kw["spe"]
            cfg["runs"].append(dict(
                regime=ast.literal_eval(n.args[0]), opt=opt,
                splits=kw.get("splits", ("train", "test")),
                mid_tag=f"step{opt['checkpointEvery'] * spe}",
                final_tag=f"step{opt['niter'] * spe}", ledger={}))
    cfg["work"] = os.path.basename(env["WORK"])
    cfg["env"] = env
    return cfg


ALL = {**presets.PRESETS, "keepbest": presets.KEEPBEST}


def test_every_ledger_script_has_a_preset():
    ported = {p.script for p in ALL.values()}
    scripts = {f"scripts/{f}" for f in os.listdir(SCRIPTS)
               if f.startswith("run_") and f.endswith(".py")}
    assert ported == scripts


@pytest.mark.parametrize("name", list(ALL))
def test_preset_equals_its_script(name):
    """(8): the work directory, the corpora, the Opt keyword arguments,
    the run_ledger keyword arguments and the result file, letter for
    letter."""
    p = ALL[name]
    cfg = script_config(p.script)
    assert p.workdir == cfg["work"]
    assert [(f, tuple(a), k) for f, a, k in p.corpora] == cfg["corpora"]
    if name == "keepbest":
        run = p.runs["center"]
        assert run.opt == cfg["opt"]
        assert p.results == cfg["results"]
        return
    mine = [dict(regime=r.regime, opt=r.opt, splits=tuple(r.splits),
                 mid_tag=r.mid_tag, final_tag=r.final_tag, ledger=r.ledger)
            for r in p.runs.values()]
    theirs = [{**r, "splits": tuple(r["splits"])} for r in cfg["runs"]]
    assert mine == theirs
    if name != "logo_wholeim":
        assert p.results == cfg["results"]
        return
    # OUT = f"lw_results_{which}.json" if which != "both" else ...
    with open(os.path.join(ROOT, p.script)) as f:
        tree = ast.parse(f.read())
    out = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", "") == "OUT")
    expr = compile(ast.Expression(out), p.script, "eval")
    assert p.results_file(p.default_runs()) == eval(expr, {"which": "both"})
    for key in p.runs:
        assert p.results_file((key,)) == eval(expr, {"which": key})
