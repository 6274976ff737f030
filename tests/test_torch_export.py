"""torch.export of the served generators (video_filler_tpu_torch/eval/
export_pt2.py) against the eager generator and against the JAX package's
StableHLO export of the same checkpoint (video_filler_tpu/eval/
export_hlo.py; tests/test_eval.py:203-293): video, the folded video3d
clips and noiseGen's second input.  The .pt2 output equals the eager G's
exactly (uint8); the JAX artifact's within one uint8 level."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jax_export

from video_filler_tpu.checkpoint import ckpt as jckpt
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.eval.export_hlo import export_generator_hlo
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.eval import export_pt2
from video_filler_tpu_torch.eval.common import load_generator

TINY = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, computeDtype="float32",
            batchSize=2, manualSeed=222, wtl2=0.999)
CASES = {
    "video": ("video", dict(predLen=2)),
    "video3d": ("video3d", dict(predLen=2, fineSize=32, video3dLevels=3)),
    "noiseGen": ("center", dict(overlapPred=4, noiseGen=True, nz=5)),
}


def jax_checkpoint(d, name, regime, seed, **kw):
    """A JAX train state saved as a checkpoint, G's conv weights scaled by
    2 and its BN running statistics drawn away from their init (as
    tests/test_torch_eval.py's)."""
    jopt = JaxOpt(**TINY, **kw)
    st = jstep.init_train_state(jax.random.PRNGKey(seed), jopt, regime)
    rs = np.random.RandomState(seed + 50)

    def params(path, leaf):
        return leaf * 2.0 if path[-1].key == "w" else leaf

    def stats(path, leaf):
        if path[-1].key == "mean":
            return jnp.asarray(rs.normal(0.0, 0.3, leaf.shape), jnp.float32)
        return jnp.asarray(rs.uniform(0.5, 2.0, leaf.shape), jnp.float32)

    st = st._replace(
        params_g=jax.tree_util.tree_map_with_path(params, st.params_g),
        state_g=jax.tree_util.tree_map_with_path(stats, st.state_g))
    return jckpt.save_checkpoint(str(d), name, 1, st)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Per case: the options, a JAX-written checkpoint, the .pt2 written by
    the CLI and reloaded, and inputs made from a seed."""
    d = tmp_path_factory.mktemp("export")
    out = {}
    for i, (name, (regime, kw)) in enumerate(CASES.items()):
        path = jax_checkpoint(d, name, regime, seed=i, **kw)
        popt = Opt(device="cpu", **TINY, **kw)
        pt2 = str(d / f"{name}.pt2")
        export_pt2.main([f"regime={regime}", f"net={path}", f"out={pt2}",
                         "device=cpu", *[f"{k}={v}" for k, v in
                                         {**TINY, **kw}.items()]])
        rs = np.random.RandomState(i)
        args = export_pt2.example_inputs(popt, regime, torch.device("cpu"))
        inputs = [rs.randint(0, 256, tuple(args[0].shape)).astype(np.uint8)]
        inputs += [rs.normal(size=tuple(a.shape)).astype(np.float32)
                   for a in args[1:]]
        out[name] = (regime, kw, popt, path, pt2, inputs)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_pt2_round_trip_equals_the_eager_generator(artifacts, name):
    regime, _, popt, path, pt2, inputs = artifacts[name]
    assert os.path.getsize(pt2) > 0
    g = torch.export.load(pt2).module()
    eager = export_pt2.ServedGenerator(
        load_generator(popt, regime, path, "cpu"),
        popt.predLen if regime == "video3d" else None)
    args = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        got, ref = g(*args), eager(*args)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == {
        "video": (2, 128, 128, 6), "video3d": (2, 32, 32, 6),
        "noiseGen": (2, 64, 64, 3)}[name]
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_pt2_matches_the_jax_export(artifacts, name):
    """The same checkpoint through the JAX package's exporter (CPU
    lowering): the two artifacts agree within one uint8 level."""
    regime, kw, _, path, pt2, inputs = artifacts[name]
    blob = export_generator_hlo(JaxOpt(**TINY, **kw), regime, path,
                                platforms=("cpu",))
    want = np.asarray(jax_export.deserialize(blob).call(
        *[jnp.asarray(a) for a in inputs]))
    with torch.no_grad():
        got = torch.export.load(pt2).module()(
            *[torch.from_numpy(a) for a in inputs]).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert int(diff.max()) <= 1, int(diff.max())


def test_export_cli_needs_a_net():
    with pytest.raises(SystemExit, match="net="):
        export_pt2.main(["regime=video", "device=cpu"])
