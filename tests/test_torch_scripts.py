"""The port's measurement and gallery tools (video_filler_tpu_torch/
scripts/) in their small ``VF_SMOKE=1`` mode on the CPU, against the JAX
package's scripts where these can run without a chip: profile_video3d's
stages, pairs and FLOP counts, and ablate_video3d_step's configurations,
each equal to the JAX script's.  measure_remat's counts: remat above
plain, gradAccum=8 within 2% of plain.  render_gallery_lw's PNGs from the
checkpoints of a 2-step tiny ``logo_wholeim`` ledger run.  The held-out
video diagnostic: the JAX-side control runners take the held-out video
configuration, and bisect_heldout_video starts the port from the JAX
run's state and step draws (JAX's weights, JAX's preprocessed batches),
its scoring on its own draws.

Tiny widths, f32, one thread.  The JAX scripts are loaded from their files
with the chip work replaced (their timers and, for the ratios, the row
printer): the configurations and counts are what is compared.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_ledger import _value as ledger_value
from video_filler_tpu.checkpoint import ckpt as jax_ckpt
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.ops import layers as jax_layers
from video_filler_tpu.train import step as jax_step
from video_filler_tpu_torch.checkpoint.ckpt import flatten_state
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import synthetic
from video_filler_tpu_torch.ledger import presets
from video_filler_tpu_torch.ledger.__main__ import main as ledger_main
from video_filler_tpu_torch import bench
from video_filler_tpu_torch.scripts import (
    ablate_video3d_step,
    bench_e2e_datadevice,
    bench_loader,
    bench_serve_video_frame,
    bench_serve_wholeim,
    bisect_heldout_video as bisect,
    measure_remat,
    profile_video3d,
    render_gallery_lw,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DRAWS_CALL = bisect.JaxDraws.__call__

torch.set_num_threads(1)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.setenv("VF_SMOKE", "1")


def test_profile_video3d_stages_and_flops_match_the_jax_script(
        smoke, monkeypatch, capsys):
    """Every stage of the JAX script, in its order, with its pair key,
    kind and FLOP count; the per-FLOP ratios printed alike."""
    rows = profile_video3d.main(["device=cpu"])
    out = capsys.readouterr().out
    jax_script = _jax_script("profile_video3d")
    got = {}
    monkeypatch.setattr(jax_script, "time_scan", lambda *a, **k: 1e-3)
    monkeypatch.setattr(jax_script, "_print_ratios",
                        lambda r: got.setdefault("rows", r))
    monkeypatch.setattr(jax_script.sys, "argv", ["profile_video3d.py"])
    # the layers are only timed there: no JAX init of their weights
    layer = lambda *a, **k: types.SimpleNamespace(  # noqa: E731
        init=lambda key: (None, None))
    for name in ("conv3d", "conv3d_transpose", "conv2d"):
        monkeypatch.setattr(jax_script, name, layer)
    monkeypatch.setattr(jax_layers, "conv2d_transpose", layer)
    jax_script.main()
    ref = got["rows"]
    assert [(r["tag"], r["pair"], r["kind"]) for r in rows] == \
        [(r["tag"], r["pair"], r["kind"]) for r in ref]
    # the JAX timer returned 1 ms: its TF/s is the FLOP count / 1e9
    np.testing.assert_allclose([r["gflops"] for r in rows],
                               [r["fwd_tfs"] for r in ref], rtol=1e-12)
    assert all(r[k] > 0 and np.isfinite(r[k]) for r in rows
               for k in ("fwd_ms", "bwd_ms", "fwd_tfs", "bwd_tfs"))
    assert len(rows) == 23 and "device: cpu (host times" in out
    # the ratios: the JAX printer's lines on the port's rows
    jax_script._print_ratios = _jax_script("profile_video3d")._print_ratios
    capsys.readouterr()
    jax_script._print_ratios(rows)
    assert capsys.readouterr().out.strip().splitlines()[1:] == \
        profile_video3d.ratios(rows)


def test_measure_remat_counts_the_recompute(smoke, capsys):
    """remat recomputes G's and D's forwards in the backward (more FLOPs);
    gradAccum=8 splits the batch (the same FLOPs within 2%); on the CPU
    memory is not measured."""
    rows = measure_remat.main(["device=cpu", "regime=center"])
    out = capsys.readouterr().out
    fl = {r["config"]: r["gflops"] for r in rows}
    assert list(fl) == ["plain", "remat", "gradAccum=8",
                        "remat+gradAccum=8"]
    assert fl["remat"] > 1.2 * fl["plain"]
    assert fl["remat+gradAccum=8"] > 1.2 * fl["gradAccum=8"]
    assert abs(fl["gradAccum=8"] - fl["plain"]) <= 0.02 * fl["plain"]
    assert out.count("memory not measured") == 5   # the device line too
    assert not any("peak_mib" in r for r in rows)


def test_measure_remat_video3d_cell(smoke, capsys):
    rows = measure_remat.main(["device=cpu", "regime=video3d"])
    fl = {r["config"]: r["gflops"] for r in rows}
    assert fl["remat"] > 1.2 * fl["plain"]
    assert abs(fl["gradAccum=8"] - fl["plain"]) <= 0.02 * fl["plain"]
    assert "video3d, batch 16" in capsys.readouterr().out


def test_ablate_video3d_step_configurations_match_the_jax_script(
        smoke, monkeypatch, capsys):
    """The two configurations per batch, in the JAX script's order, with
    the JAX script's options (the port's ``device`` aside), each timed."""
    rows = ablate_video3d_step.main(["2", "device=cpu"])
    assert [(r["batch"], r["config"]) for r in rows] == [
        (2, "f32 Adam"), (2, "bf16 moments")]
    assert all(r["ms"] > 0 and np.isfinite(r["clips_s"]) for r in rows)
    assert "video3d b=   2 bf16 moments" in capsys.readouterr().out
    seen = {"port": [], "jax": []}
    monkeypatch.setattr(ablate_video3d_step, "bench_step",
                        lambda opt, d, i: seen["port"].append(opt) or 1.0)
    jax_script = _jax_script("ablate_video3d_step")
    monkeypatch.setattr(jax_script, "bench_step",
                        lambda opt: seen["jax"].append(opt) or 1.0)
    monkeypatch.setattr(jax_script.sys, "argv", ["ablate", "3", "5"])
    jax_script.main()
    ablate_video3d_step.main(["3", "5", "device=cpu"])
    monkeypatch.delenv("VF_SMOKE")
    ablate_video3d_step.main(["device=cpu"])
    monkeypatch.setattr(jax_script.sys, "argv", ["ablate"])
    jax_script.main()

    def fields(opt):
        d = dataclasses.asdict(opt)
        d.pop("device", None)
        return d
    assert [fields(o) for o in seen["port"]] == \
        [fields(o) for o in seen["jax"]]
    assert [o.batchSize for o in seen["port"]] == [3, 3, 5, 5, 32, 32,
                                                   128, 128]


@pytest.mark.parametrize("tool", [profile_video3d, measure_remat,
                                  ablate_video3d_step, bench,
                                  bench_e2e_datadevice, bench_loader,
                                  bench_serve_video_frame,
                                  bench_serve_wholeim])
def test_tools_run_on_the_card_unless_told(tool):
    """Without ``device=cpu`` a tool takes the card, and where there is
    none it raises rather than measure the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])


def test_render_gallery_lw_from_a_tiny_logo_wholeim_run(tmp_path, capsys):
    """The ledger writes the checkpoint names the gallery reads
    (lw_lg_final_999, lw_wi_final_999); the gallery renders the logo grids
    and the wholeim frame through the full-frame server."""
    work = tmp_path / "lw"
    work.mkdir()
    # small corpora of the preset's frame sizes (build_corpora keeps them)
    synthetic.make_video_corpus(str(work / "corpus"), n_videos=1, frames=10,
                                h=180, w=240)
    synthetic.make_mask_png(str(work / "mask.png"), h=180, w=240)
    synthetic.make_paired_folders(str(work / "pairs"), n=8, h=160, w=200)
    tiny = ["nef=8", "ngf=8", "ndf=8", "nBottleneck=32"]
    ledger_main(["logo_wholeim", "--workdir", str(work), "--device", "cpu",
                 "--max-steps", "2", "--n-batches", "1", *tiny,
                 "computeDtype=float32", "batchSize=2", "nThreads=0"])
    ckpts = sorted(os.listdir(work / "checkpoints"))
    assert "lw_lg_final_999_state.npz" in ckpts
    assert "lw_wi_final_999_state.npz" in ckpts
    out = tmp_path / "gallery"
    render_gallery_lw.main([str(work), str(out), "device=cpu", *tiny])
    shapes = {f: np.asarray(Image.open(out / f)).shape
              for f in sorted(os.listdir(out))}
    grid = (2 * 130 - 2, 4 * 130 - 2, 3)     # 8 tiles of 128, 4 columns
    assert shapes == {"logo_inpaint.png": grid, "logo_masked.png": grid,
                      "wholeim_serve_inpaint.png": (180, 240, 3),
                      "wholeim_serve_masked.png": (180, 240, 3),
                      "wholeim_serve_orig.png": (180, 240, 3)}
    orig, inpainted = (np.asarray(Image.open(out / f"wholeim_serve_{k}.png"))
                       for k in ("orig", "inpaint"))
    mask = np.asarray(Image.open(work / "mask.png").convert("L")) > 128
    # the server composites: outside the mask the frame is kept
    np.testing.assert_array_equal(inpainted[~mask], orig[~mask])
    assert "frame: corpus/gt/" in capsys.readouterr().out


def test_bisect_takes_the_jax_runs_start_and_draws(tmp_path, monkeypatch):
    """scripts/control_heldout_video_start.py writes the JAX loop's initial
    state (from the second half of split(PRNGKey(seed)), loop.py) and each
    step's preprocess draws; bisect_heldout_video swaps them into the
    port: its init_train_state gives the JAX state's leaves, and step i's
    preprocess makes the batch JAX's preprocess makes from step i's key --
    random blocks where a sample's mask crop is empty, and flips."""
    out = tmp_path / "start"
    tiny = ["nef=8", "ngf=8", "ndf=8", "nBottleneck=32",
            "computeDtype=float32"]
    subprocess.run([sys.executable, "scripts/control_heldout_video_start.py",
                    "222", str(out), "6", *tiny], cwd=ROOT, check=True,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300,
                   capture_output=True)
    state_path = out / "jax_video_s222_init_0_state.npz"
    for mod, name in ((bisect.common, "init_train_state"),
                      (bisect.loop, "init_train_state"),
                      (bisect.step_mod, "video_draws"),
                      (bisect.common, "train"), (bisect.common, "score"),
                      (bisect.step_mod, "fused_weighted_mse"),
                      (bisect.ledger_cli, "run_ledger")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    bisect.start_from(str(state_path))
    draws = bisect.draws_from(str(out / "jax_video_s222_draws.npz"))
    popt = Opt(device="cpu", predLen=2, batchSize=64, nef=8, ngf=8, ndf=8,
               nBottleneck=32, computeDtype="float32", weight_nomask=0.05,
               wtl2=0.999)
    jopt = JaxOpt(**{k: v for k, v in dataclasses.asdict(popt).items()
                     if k != "device"})

    state = bisect.loop.init_train_state(popt, "video",
                                         torch.Generator().manual_seed(0))
    _, k_init = jax.random.split(jax.random.PRNGKey(222))
    ref = jax_ckpt._flatten(jax.device_get(
        jax_step.init_train_state(k_init, jopt, "video")))
    mine = flatten_state(state)
    assert set(mine) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]), k)

    rs = np.random.RandomState(0)
    raw = rs.randint(0, 256, (64, 128, 128, 6), dtype=np.uint8)
    mask = np.zeros((64, 128, 128, 1), np.uint8)
    mask[::2, 40:80, 30:90] = 1                  # odd samples: random blocks
    jpre = jax_step.make_preprocess(jopt, "video")
    ppre = bisect.step_mod.make_preprocess(popt, "video")
    draws.step = 0
    for i in range(3):
        k1, _ = jax.random.split(jax.random.PRNGKey(
            (222 * 1_000_003 + i) % 2 ** 31))
        want = jpre({"raw": raw, "mask": mask}, k1)
        got = ppre({"raw": torch.from_numpy(raw),
                    "mask": torch.from_numpy(mask)})
        for k in ("real", "mask"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), f"{i} {k}")
    assert draws.step == 3

    # The whole diagnostic at tiny width: the loop's 6 steps (2 epochs)
    # take rows 0-5 while the save-free ledger scores at init, after epoch
    # 1 (in the loop's hook) and at the end with its own draws.
    served = []
    monkeypatch.setattr(bisect.JaxDraws, "__call__", lambda self, *a: (
        served.append(self.step), JAX_DRAWS_CALL(self, *a))[1])
    work = tmp_path / "w"
    bisect.main(["--init", str(state_path), "--draws",
                 str(out / "jax_video_s222_draws.npz"), "--plain-loss",
                 "--workdir", str(work), "--device", "cpu", "--max-steps",
                 "6", "--n-batches", "1", *tiny, "checkpointEvery=1",
                 "nThreads=0"])
    assert [i for i in served if i is not None] == list(range(6))
    with open(work / "heldout_results.json") as f:
        rows = json.load(f)
    assert [r["ckpt"] for r in rows] == ["init", "init", "step3", "step3",
                                         "step6", "step6"]
    assert {r["bisect"] for r in rows} == {"init+draws+plain_loss"}
    assert not os.path.isdir(work / "checkpoints")


@pytest.mark.parametrize("script", ["control_heldout_video_seed.py",
                                    "control_heldout_video_start.py"])
def test_control_scripts_run_the_heldout_video_configuration(script):
    """The JAX-side control runners (read with ``ast``: running one
    trains a model) take scripts/run_heldout_ledgers.py's video Opt -- the
    heldout preset's video run, which test_torch_ledger.py holds to that
    script -- with only manualSeed from the command line."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        tree = ast.parse(f.read())
    env = {"SEED": 223}
    for node in sorted((n for n in ast.walk(tree)
                        if isinstance(n, ast.Assign)
                        and isinstance(n.targets[0], ast.Name)),
                       key=lambda n: n.lineno):
        try:
            env[node.targets[0].id] = ledger_value(node.value, env)
        except (ValueError, TypeError):
            pass     # a value computed at run time, not an option
    want = dict(presets.PRESETS["heldout"].runs["video"].opt,
                manualSeed=223)
    assert env["opt"] == want
