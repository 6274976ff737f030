"""The port's Torch7 exchange (checkpoint/t7.py, ``net=*.t7`` in
eval/common.load_generator and serve.py, the eval/export.py CLI) against
the JAX package's.

* The reader: every reader case of tests/test_t7_import.py that needs no
  JAX model runs with its ``read_t7`` reading each fixture through both
  packages' readers, which must give the same tree (types, values, dtypes,
  shared objects) or raise the same error.
* Loading: a .t7 written by the JAX ``export_generator`` (center 64-out,
  video 128-out at 12 channels) gives the port's G the JAX G's output at
  rtol 1e-5 in f32 (convolutions summed in another order).
* Exporting: the port's CLI writes the JAX CLI's file byte for byte.
"""

import io
import re
import urllib.request

import numpy as np
import pytest
import torch

import test_t7_import as jt7_tests
from test_torch_eval import jax_checkpoint, opts
from video_filler_tpu.checkpoint import t7 as jt7
from video_filler_tpu.eval import common as jcommon
from video_filler_tpu.eval import export as jexport
from video_filler_tpu_torch.checkpoint import t7 as tt7
from video_filler_tpu_torch.eval import common, export
from video_filler_tpu_torch.serve import InpaintServer

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
JAX_READ_T7 = jt7.read_t7

READER_CASES = [
    "test_reader_primitives", "test_reader_shared_storage",
    "test_reader_storage_offset_view", "test_reader_char_and_byte_storages",
    "test_reader_legacy_no_version_header",
    "test_reader_shared_table_identity",
    "test_reader_int_long_double_storages",
    "test_reader_cuda_typed_storages",
    "test_reader_shared_storage_across_modules",
    "test_reader_nested_concat_table_graph", "test_reader_fuzz_random_trees",
    "test_reader_rejects_oob_tensor", "test_reader_truncated_storage",
    "test_import_spatial_convolution_mm",
]


def _same_tree(j, t, seen, path="root"):
    """``t`` (the port's) mirrors ``j`` (JAX's): same structure, values,
    dtypes, and the same sharing of objects."""
    if isinstance(j, (dict, jt7.TorchObject, np.ndarray)):
        if id(j) in seen:
            assert seen[id(j)] is t, f"{path}: sharing differs"
            return
        seen[id(j)] = t
    if isinstance(j, jt7.TorchObject):
        assert isinstance(t, tt7.TorchObject), path
        assert t.torch_type == j.torch_type, path
        _same_tree(j.fields, t.fields, seen, path + ".fields")
    elif isinstance(j, dict):
        assert isinstance(t, dict) and list(t) == list(j), path
        for k in j:
            _same_tree(j[k], t[k], seen, f"{path}.{k}")
    elif isinstance(j, np.ndarray):
        assert isinstance(t, np.ndarray) and t.dtype == j.dtype, path
        np.testing.assert_array_equal(t, j, err_msg=path)
    elif isinstance(j, tuple):          # a skipped Lua function
        assert isinstance(t, tuple) and t[0] == j[0], path
        _same_tree(j[1], t[1], seen, path + ".upvalues")
    else:
        assert type(t) is type(j) and t == j, path


def _dual_read_t7(path):
    """Read ``path`` with both packages' readers; return the JAX tree after
    checking that the port's mirrors it (or that both raise alike)."""
    outcome = {}
    for name, reader in (("jax", JAX_READ_T7), ("port", tt7.read_t7)):
        try:
            outcome[name] = ("ok", reader(path))
        except (ValueError, EOFError) as e:
            outcome[name] = ("raise", type(e), str(e))
    if outcome["jax"][0] == "raise":
        assert outcome["port"] == outcome["jax"]
        raise outcome["jax"][1](outcome["jax"][2])
    assert outcome["port"][0] == "ok", outcome["port"]
    _same_tree(outcome["jax"][1], outcome["port"][1], {})
    return outcome["jax"][1]


@pytest.mark.parametrize("case", READER_CASES)
def test_reader_gives_the_jax_tree_on_the_jax_fixtures(case, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(jt7_tests, "read_t7", _dual_read_t7)
    monkeypatch.setattr(jt7, "read_t7", _dual_read_t7)  # local imports
    getattr(jt7_tests, case)(tmp_path)
    if case == "test_import_spatial_convolution_mm":
        mods = tt7.flatten_modules(tt7.read_t7(str(tmp_path / "mm.t7")))
        jmods = jt7.flatten_modules(JAX_READ_T7(str(tmp_path / "mm.t7")))
        np.testing.assert_array_equal(
            tt7.import_sequence(mods, ["conv0"])[0]["conv0"]["w"],
            jt7.import_sequence(jmods, ["conv0"])[0]["conv0"]["w"])


def _model_args(popt):
    keys = ("nef", "ngf", "ndf", "nBottleneck", "computeDtype", "predLen",
            "overlapPred")
    return [f"{k}={getattr(popt, k)}" for k in keys]


def _jax_t7(tmp_path, regime, seed, **kw):
    """(JAX Opt, port Opt, .t7 path, the JAX checkpoint it came from): the
    G of a JAX checkpoint (weights scaled, BN statistics drawn away from
    init) written by the JAX exporter's CLI."""
    jopt, popt = opts(regime, **kw)
    net = jax_checkpoint(tmp_path, regime, regime, seed=seed, **kw)
    out = str(tmp_path / f"{regime}.t7")
    jexport.main([f"regime={regime}", f"net={net}", f"out={out}",
                  *_model_args(popt)])
    return jopt, popt, out, net


@pytest.mark.parametrize("regime,kw,shape", [
    ("center", {}, (2, 128, 128, 3)),
    ("video", dict(predLen=4), (2, 128, 128, 12))])
def test_jax_written_t7_loads_with_the_jax_output(regime, kw, shape,
                                                  tmp_path):
    """center's 64-out G; video's 128-out G on 12 channels (predLen 4)."""
    jopt, popt, path, _ = _jax_t7(tmp_path, regime, seed=2, **kw)
    fwd, params, bn = jcommon.load_generator(jopt, regime, path)
    gen = common.load_generator(popt, regime, path, "cpu")
    x = np.random.RandomState(5).uniform(-1, 1, shape).astype(np.float32)
    with torch.inference_mode():
        got = gen(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fwd(params, bn, x)), **FWD)
    assert not gen.training


@pytest.mark.parametrize("regime", ["center", "video"])
def test_export_cli_writes_the_jax_file_byte_for_byte(regime, tmp_path):
    _, _, jpath, net = _jax_t7(tmp_path, regime, seed=4)
    ppath = str(tmp_path / "port.t7")
    export.main([f"regime={regime}", f"net={net}", f"out={ppath}",
                 *_model_args(opts(regime)[1])])
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()


def test_export_and_load_refusals(tmp_path):
    """noiseGen exports refuse with the JAX words; a .t7 for video3d, and a
    video3d export, refuse by name; a .t7 (the reference's plain netG) read
    for a noiseGen or useBias G names the layers it lacks."""
    net = jax_checkpoint(tmp_path, "ng", "center", noiseGen=True, nz=5)
    args = ["regime=center", f"net={net}", f"out={tmp_path / 'x.t7'}",
            *_model_args(opts("center")[1]), "noiseGen=1", "nz=5"]
    errs = []
    for main in (jexport.main, export.main):
        with pytest.raises(ValueError) as e:
            main(args)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "non-noiseGen" in errs[0]
    _, popt = opts("video")
    v3 = popt.replace(predLen=2, fineSize=32, video3dLevels=3)
    with pytest.raises(SystemExit, match="video3d"):
        common.load_generator(v3, "video3d", str(tmp_path / "g.t7"), "cpu")
    with pytest.raises(SystemExit, match="video3d"):
        export.main(["regime=video3d", f"net={net}", "predLen=2",
                     "fineSize=32", "video3dLevels=3"])
    _, popt, plain, _ = _jax_t7(tmp_path, "center", seed=1)
    for kw, layer in ((dict(noiseGen=True, nz=5), "['noise.weight']"),
                      (dict(useBias=True), "['dec.up0.bias', ")):
        with pytest.raises(SystemExit, match=re.escape(f"has no {layer}")):
            common.load_generator(popt.replace(**kw), "center", plain, "cpu")


def test_server_answers_from_the_t7_as_from_its_npz(tmp_path):
    """One POST to a server on the .t7 and one to a server on the .npz it
    was exported from: the same uint8 bytes back."""
    _, popt, t7_path, net = _jax_t7(tmp_path, "video", seed=6)
    rs = np.random.RandomState(8)
    ctx = rs.randint(0, 256, (128, 128, 6), np.uint8)
    mask = np.zeros((128, 128, 1), np.uint8)
    mask[40:80, 30:90] = 1
    outs = []
    for path in (t7_path, net):
        srv = InpaintServer(popt, "video", path, max_delay_ms=1.0)
        try:
            buf = io.BytesIO()
            np.savez(buf, ctx=ctx, mask=mask)
            req = urllib.request.Request(
                f"http://localhost:{srv.port}/inpaint", data=buf.getvalue(),
                method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                with np.load(io.BytesIO(r.read())) as d:
                    outs.append(d["out"])
        finally:
            srv.close()
    assert outs[0].shape == ctx.shape and outs[0].dtype == np.uint8
    np.testing.assert_array_equal(outs[0], outs[1])
