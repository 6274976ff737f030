"""The port imports nothing of jax or of the JAX package, and its copies of
the JAX package's host modules (the option table, the PNG/GIF writers, the
metrics logger, the HTTP handler base) behave as the originals do.

The copies are held to the originals here, the one place that imports both.
"""

import ast
import dataclasses
import math
import os
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from video_filler_tpu import config as jconfig
from video_filler_tpu.utils import httpbase as jhttpbase
from video_filler_tpu.utils import io as jio
from video_filler_tpu.utils import logger as jlogger
from video_filler_tpu_torch import config as tconfig
from video_filler_tpu_torch.utils import httpbase as thttpbase
from video_filler_tpu_torch.utils import io as tio
from video_filler_tpu_torch.utils import logger as tlogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "video_filler_tpu_torch")


# jax, the JAX package, and the JAX package's scripts/ (the ledgers'
# shared module among them)
FORBIDDEN = ("jax", "video_filler_tpu", "scripts", "ledger_common")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


@pytest.mark.parametrize("rel", _port_sources())
def test_no_source_imports_jax_or_the_jax_package(rel):
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{rel} imports {bad}"


_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "video_filler_tpu", "scripts",
                                  "ledger_common"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import video_filler_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "video_filler_tpu", "scripts", "ledger_common")]
assert not loaded, loaded
print(" ".join(names))
"""

# Modules the walk must reach: the copies of the JAX package's host
# modules that import no JAX (t7, dashboard, native) and the port's own.
NEW_MODULES = ["checkpoint.t7", "utils.dashboard", "data.native",
               "data.device_data", "eval.export", "ledger.common",
               "ledger.presets", "ledger.keepbest", "ledger.rescore",
               "ledger.compare", "scripts.common", "scripts.profile_video3d",
               "scripts.measure_remat", "scripts.ablate_video3d_step",
               "scripts.render_gallery_lw", "scripts.bisect_heldout_video",
               "bench", "scripts.bench_e2e_datadevice",
               "scripts.bench_loader", "scripts.bench_serve_video_frame",
               "scripts.bench_serve_wholeim"]


def test_every_port_module_imports_with_the_jax_package_refused():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = proc.stdout.split()
    assert len(names) >= 45                      # every module was reached
    for mod in NEW_MODULES:
        assert f"video_filler_tpu_torch.{mod}" in names, mod


# --- the option table ------------------------------------------------------

def test_opt_has_the_jax_fields_in_order_plus_device():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jconfig.Opt)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tconfig.Opt)]
    assert tf[:-1] == jf
    assert tf[-1] == ("device", "str", "cuda")


@pytest.mark.parametrize("kw", [{}, dict(predLen=4, nc=3, array_h=2,
                                         array_w=3, out_h=1),
                                dict(donkey_file="datavid_norandblk")])
def test_opt_properties_and_replace_match(kw):
    j, t = jconfig.Opt(**kw), tconfig.Opt(**kw)
    for prop in ("noRandBlk", "nc_total", "nc_wholeim_in", "nc_wholeim_out"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert dataclasses.asdict(t.replace(nef=16, name="x")) == {
        **dataclasses.asdict(j.replace(nef=16, name="x")), "device": "cuda"}


def test_opt_rejects_a_fine_size_not_divisible_by_4():
    for cls in (jconfig.Opt, tconfig.Opt):
        with pytest.raises(ValueError, match="divisible by 4"):
            cls(fineSize=130)


def _outcome(fn, *args):
    try:
        v = fn(*args)
    except (ValueError, SystemExit) as e:
        return type(e).__name__, str(e)
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    return type(v).__name__, v


COERCE_CASES = [("true", False), ("Off", True), ("0", True), ("2", False),
                ("maybe", False), ("3", 0), ("3.0", 0), ("3.5", 0),
                ("inf", 0), ("-7", 0), ("2e-4", 0.1), ("nan", 0.1),
                ("inf", math.inf), ("abc", 0.1), ("12", "name"),
                ("", "name"), (" 1 ", 0)]


@pytest.mark.parametrize("raw,default", COERCE_CASES)
def test_coerce_matches(raw, default):
    assert _outcome(tconfig._coerce, raw, default) == \
        _outcome(jconfig._coerce, raw, default)


ENV_CASES = [{}, {"batchSize": "16", "wtl2": "0.999", "display": "false",
                  "name": "run", "ntrain": "320", "UNRELATED": "1"},
             {"conditionAdv": "perhaps"}, {"nef": "6.5"},
             {"maskValue": "0.5", "donkey_file": "x_norandblk"}]


def _asdict_or_error(fn, *args):
    try:
        opt = fn(*args)
    except SystemExit as e:
        return "SystemExit", str(e)
    d = dataclasses.asdict(opt)
    d.pop("device", None)
    return d


@pytest.mark.parametrize("env", ENV_CASES)
def test_from_env_matches(env):
    assert _asdict_or_error(tconfig.from_env, None, env) == \
        _asdict_or_error(jconfig.from_env, None, env)


SPLIT_CASES = [(["regime=video", "nef=8"], "center"), (["nef=8"], "center"),
               (["nef=8"], "logo"), (["regime=bogus"], "center"),
               (["video"], "center"), ([], "wholeim"),
               (["regime=video3d", "regime=logo", "a=b=c"], "center")]


@pytest.mark.parametrize("argv,default", SPLIT_CASES)
def test_split_regime_matches(argv, default):
    assert tconfig.REGIMES == jconfig.REGIMES
    assert _outcome(tconfig.split_regime, argv, default) == \
        _outcome(jconfig.split_regime, argv, default)


# --- the host utilities ----------------------------------------------------

def _images():
    rs = np.random.RandomState(0)
    return {
        "png_float": ("save_png", rs.uniform(-1.2, 1.2, (9, 11, 3))
                      .astype(np.float32)),
        "png_gray_u8": ("save_png", rs.randint(0, 256, (9, 11, 1),
                                               np.uint8)),
        "grid": ("save_image_grid", rs.uniform(-1, 1, (5, 8, 6, 3))
                 .astype(np.float32)),
        "gif_gray": ("save_gif", rs.uniform(-1, 1, (4, 8, 6, 1))
                     .astype(np.float32)),
        "gif_u8": ("save_gif", rs.randint(0, 256, (3, 8, 6, 3), np.uint8)),
    }


@pytest.mark.parametrize("case", list(_images()))
def test_image_writers_write_the_same_bytes(tmp_path, case):
    fn, arr = _images()[case]
    ext = "gif" if fn == "save_gif" else "png"
    paths = []
    for name, mod in (("jax", jio), ("port", tio)):
        path = str(tmp_path / name / f"out.{ext}")
        getattr(mod, fn)(path, arr)
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_metrics_logger_writes_the_same_lines(tmp_path, capsys):
    out = {}
    for name, mod in (("jax", jlogger), ("port", tlogger)):
        log = mod.MetricsLogger("run", log_dir=str(tmp_path / name))
        log.log_step(1, 3, 10, {"errG_l2": 0.123456789, "errD": 1.5},
                     0.0123456, 0.001)
        log.log_eval(1, "test", {"psnr_db": 21.25, "hole_l2": 0.04})
        log.log_epoch(1, 25, 12.3456)
        log.close()
        with open(log.path) as f:
            out[name] = (f.read(), capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert out["port"][0].count("\n") == 3


def _serve_once(handler_base):
    """(status, headers, body, stderr) of one GET to a handler on
    ``handler_base`` that answers with ``_send``."""

    class Handler(handler_base):
        def do_GET(self):
            self._send(201, "text/plain", b"hello")

    srv = ThreadingHTTPServer(("localhost", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(
                f"http://localhost:{srv.server_address[1]}/x",
                timeout=30) as r:
            return (r.status, r.headers["Content-Type"],
                    r.headers["Content-Length"], r.read())
    finally:
        srv.shutdown()
        srv.server_close()


def test_quiet_handler_answers_as_the_jax_one(capsys):
    got = _serve_once(thttpbase.QuietHandler)
    assert got == _serve_once(jhttpbase.QuietHandler)
    assert got == (201, "text/plain", "5", b"hello")
    assert capsys.readouterr().err == ""   # no access log
