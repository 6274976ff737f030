"""The port's data and model parallelism (video_filler_tpu_torch/parallel/
mesh.py and the sharded train step) against the JAX package's step, in
gloo worlds of 2 and 4 processes on the CPU (the counterpart of
tests/test_parallel.py, which shards over 8 virtual devices).

The parent makes the weights (the JAX init) and the batch with numpy, runs
the JAX step unsharded, and hands the converted state to the ranks
(tests/_torch_workers.py: torch and the port only), which run the port's
sharded step.  Tolerances, as the JAX parallel tests': metrics rtol 1e-4 /
atol 1e-5; parameters after the first Adam step atol 4.1e-3 (about
lr*sign(g): a gradient near 0 whose sign flips under another reduction
order moves a weight by 2*lr_G, tests/test_parallel.py:47-52); BN running
statistics rtol 1e-4 / atol 1e-5.  The replicas must be bitwise equal.

The metrics are forward values and a first Adam step moves a weight by
about lr whatever its gradient's size, so neither sees a wrong gradient
reduction.  The gradients do: each net's Adam first moments after the
step, (1 - beta1) times the reduced gradient, are held to JAX's leaf by
leaf, the largest difference within 0.1 of the leaf's largest value.  A
dropped 1/world share, or a bucket summed over the wrong group, moves a
gradient by its own size or more (tests/gradient_readings.py reads 1.0
to 3.0), while two f32 steps that are both right differ by up to 3.3e-2
on the center batch, a discrete near-tie (ROADMAP §C): JAX's f32 step is
3.3e-2 of a G leaf off the port's float64 step, and the port's own f32
step 1.1e-5 with 8 threads but 8.8e-3 with one.  Every other case agrees
within 3.5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_workers as workers
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.checkpoint import convert
from video_filler_tpu_torch.parallel import mesh as mesh_mod
from video_filler_tpu_torch.parallel.launch import run_world

TINY = dict(nef=8, ngf=8, ndf=8, nBottleneck=64, batchSize=8,
            computeDtype="float32", wtl2=0.999)
V3D = dict(nef=8, ngf=8, ndf=8, nBottleneck=64, predLen=2, batchSize=8,
           fineSize=32, video3dLevels=3, wtl2=0.999, weight_nomask=0.05,
           computeDtype="float32")
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 4.1e-3
GRAD_LIMIT = 0.1
BN_TOL = dict(rtol=1e-4, atol=1e-5)
WORLD_S = 120


def _jax_mu(opt_state) -> dict:
    """The first moments of a JAX optimizer state (optax's or the bf16
    one's) as a port state dict, in f32."""
    mu = opt_state["mu"] if isinstance(opt_state, dict) else opt_state[0].mu
    mu = jax.tree.map(lambda x: np.asarray(x, np.float32), mu)
    return {k: v.numpy() for k, v in convert.tree_to_state_dict(mu).items()}


def _jax_case(regime, kw, batch, seed=2, with_init=False):
    """(JAX init as full port state dicts, JAX metrics, new state and
    first moments, the global noise the JAX step drew); ``with_init``:
    the step's initializer is the init's G, kept as ``init``."""
    jopt = JaxOpt(**kw)
    state = jstep.init_train_state(jax.random.PRNGKey(0), jopt, regime)
    key = jax.random.PRNGKey(seed)
    extra = ((state.params_g, state.state_g),) if with_init else ()
    new, metrics = jax.jit(jstep.make_train_step(
        jopt, regime, with_init=with_init))(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, key, *extra)
    sd_g, sd_d = convert.from_jax(state.params_g, state.state_g,
                                  state.params_d, state.state_d)
    noise = None
    if jopt.noiseGen:
        noise = np.array(jstep._draw_noise(jax.random.split(key)[0], jopt,
                                           jopt.batchSize))
    gen = {k: v.numpy() for k, v in sd_g.items()}
    return {"opt": kw, "regime": regime, "batch": batch,
            "gen": gen, "disc": {k: v.numpy() for k, v in sd_d.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "new": new, "noise": noise, "init": gen if with_init else None,
            "mu": {"gen": _jax_mu(new.opt_g), "disc": _jax_mu(new.opt_d)}}


def _case(ref, regime, kw, batch, n_data, n_shard, kind="model"):
    return {"opt": kw, "regime": regime, "n_data": n_data,
            "n_shard": n_shard, "kind": kind, "batch": batch,
            "gen": ref["gen"], "disc": ref["disc"], "noise": ref["noise"],
            "init": ref["init"]}


def check_gradients(label, got_mu, ref_mu, limit=GRAD_LIMIT):
    """Each net's Adam first moments, leaf by leaf: the largest difference
    over the leaf's largest value at most ``limit``."""
    for net in ("gen", "disc"):
        assert sorted(got_mu[net]) == sorted(ref_mu[net]), net
        for k, b in ref_mu[net].items():
            rel = np.abs(got_mu[net][k] - b).max() / max(np.abs(b).max(),
                                                         1e-30)
            assert rel <= limit, (f"{net} {k}: gradient {rel:.2e} of its "
                                  f"scale off {label} (limit {limit:g})")


def check_against_jax(outs, ref):
    """Every rank's result against the JAX step, and the replicas bitwise
    equal to each other."""
    for o in outs[1:]:
        for net in ("gen", "disc"):
            for k, v in outs[0][net].items():
                np.testing.assert_array_equal(v, o[net][k], err_msg=k)
    got = outs[0]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][0][k], v, err_msg=k,
                                   **METRIC_TOL)
    check_gradients("the JAX step", got["mu"], ref["mu"])
    new = ref["new"]
    for net, params, stats in (("gen", new.params_g, new.state_g),
                               ("disc", new.params_d, new.state_d)):
        ours_p, ours_s = convert.state_dict_to_tree(
            {k: torch.from_numpy(v) for k, v in got[net].items()})
        for a, b in zip(jax.tree.leaves(ours_p), jax.tree.leaves(params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=PARAM_ATOL)
        for a, b in zip(jax.tree.leaves(ours_s), jax.tree.leaves(stats)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       **BN_TOL)


@pytest.fixture(scope="module")
def center():
    rs = np.random.RandomState(0)
    batch = {"real": rs.rand(8, 128, 128, 3).astype(np.float32) * 2 - 1}
    return batch, _jax_case("center", TINY, batch)


@pytest.fixture(scope="module")
def noise_center():
    kw = dict(TINY, noiseGen=True, nz=5)
    rs = np.random.RandomState(1)
    batch = {"real": rs.rand(8, 128, 128, 3).astype(np.float32) * 2 - 1}
    return kw, batch, _jax_case("center", kw, batch, seed=4)


@pytest.fixture(scope="module")
def video3d():
    rs = np.random.RandomState(0)
    mask = np.zeros((8, 1, 32, 32, 1), np.float32)
    mask[:, :, 8:20, 8:20] = 1.0
    batch = {"real": rs.rand(8, 2, 32, 32, 3).astype(np.float32) * 2 - 1,
             "mask": mask}
    return batch, _jax_case("video3d", V3D, batch, seed=3)


@pytest.fixture(scope="module")
def bn_inputs():
    """Zero-mean inputs (the JAX one-pass variance loses digits on an
    offset mean, ROADMAP §C; the port's is two-pass either way)."""
    rs = np.random.RandomState(5)
    x = rs.randn(8, 6, 5, 5).astype(np.float32)
    return (x, (1 + 0.1 * rs.randn(6)).astype(np.float32),
            (0.1 * rs.randn(6)).astype(np.float32),
            rs.randn(8, 6, 5, 5).astype(np.float32))


# The other step options at once, under TP: D conditioned on the context,
# the microbatches, G and D recomputed in the backward (their collectives
# issued again), bf16 Adam moments (sharded in bf16).
OPTIONS = dict(TINY, overlapPred=4, conditionAdv=True, gradAccum=2,
               remat=True, adamMomentsBf16=True)


@pytest.fixture(scope="module")
def options_ref(center):
    return _jax_case("center", OPTIONS, center[0])


@pytest.fixture(scope="module")
def world2(center, noise_center, bn_inputs, options_ref):
    """One gloo world of 2: DP-2 center, TP-2 center noiseGen, global BN,
    TP-2 with the other step options."""
    batch, ref = center
    kw, nbatch, nref = noise_center
    return run_world(2, workers.many, ([
        ("sharded_step", (_case(ref, "center", TINY, batch, 2, 1),)),
        ("sharded_step", (_case(nref, "center", kw, nbatch, 1, 2),)),
        ("global_bn", bn_inputs),
        ("sharded_step", (_case(options_ref, "center", OPTIONS, batch, 1,
                                2),)),
    ],), device="cpu", timeout_s=WORLD_S)


@pytest.fixture(scope="module")
def world4(center, video3d):
    """One gloo world of 4: the meshes, DP-4 and TP data 2 x model 2
    center, TP 2x2 video3d."""
    batch, ref = center
    vbatch, vref = video3d
    return run_world(4, workers.many, ([
        ("mesh_facts", ()),
        ("sharded_step", (_case(ref, "center", TINY, batch, 4, 1),)),
        ("sharded_step", (_case(ref, "center", TINY, batch, 2, 2),)),
        ("sharded_step", (_case(vref, "video3d", V3D, vbatch, 2, 2),)),
    ],), device="cpu", timeout_s=WORLD_S)


def test_mesh_shapes(world4):
    facts = [r[0] for r in world4]
    shapes = facts[0]
    assert shapes["default"][0] == {"data": 4, "model": 1}
    assert shapes["2x2"][0] == {"data": 2, "model": 2}
    assert shapes["0x2"][0] == {"data": 2, "model": 2}
    assert shapes["seq"][0] == {"data": 2, "seq": 2}
    # rank r sits at (r // 2, r % 2) of the 2x2 mesh
    assert [(f["2x2"][1].data_rank, f["2x2"][1].shard_rank)
            for f in facts] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [shapes[k][2] for k in ("default", "2x2", "seq")] == [4, 2, 2]
    assert "world size is 4" in shapes["idle"]


def test_make_mesh_rejects_bad_shapes():
    """1 process + a model axis of 2, a mesh larger or smaller than the
    world, n_model < 1: each raises clearly; n_data 0 means the rest."""
    with pytest.raises(ValueError, match="does not fit"):
        mesh_mod.mesh_shape(None, 2, 1)
    with pytest.raises(ValueError, match="needs 8 processes"):
        mesh_mod.mesh_shape(4, 2, 1)
    with pytest.raises(ValueError, match="idle rank"):
        mesh_mod.mesh_shape(1, 2, 4)
    with pytest.raises(ValueError, match="n_model"):
        mesh_mod.mesh_shape(None, 0, 8)
    assert mesh_mod.mesh_shape(0, 2, 8) == (4, 2)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh()


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_single_device(center, world2, world4, n):
    """Sharding the batch over n ranks does not change the math: global BN
    statistics and summed gradient shares equal the one-device JAX step."""
    outs = [r[0] for r in world2] if n == 2 else [r[1] for r in world4]
    assert [o["coords"] for o in outs] == [(n, i, 1, 0) for i in range(n)]
    check_against_jax(outs, center[1])


def test_tp_step_matches_replicated(center, world4):
    """data 2 x model 2: the column-parallel conv5, local bott_bn and
    row-parallel up0 give the replicated (JAX) step."""
    check_against_jax([r[2] for r in world4], center[1])


def test_tp_params_actually_sharded(world4):
    nb = TINY["nBottleneck"]
    for r in world4:
        o = r[2]
        assert o["shapes"]["enc.conv5.weight"] == (nb // 2, 64, 4, 4)
        assert o["shapes"]["bott_bn.weight"] == (nb // 2,)
        assert o["shapes"]["bott_bn.running_var"] == (nb // 2,)
        assert o["shapes"]["dec.up0.weight"] == (nb // 2, 64, 4, 4)
        assert o["shapes"]["dec.up1.weight"] == (64, 32, 4, 4)  # replicated
        assert o["moments"]["enc.conv5.weight"] == (nb // 2, 64, 4, 4)
        # gathered back, the full layout
        assert o["gen"]["enc.conv5.weight"].shape == (nb, 64, 4, 4)


def test_tp_rules_fail_loudly_on_rename():
    """A generator whose names do not match the TP rules raises instead of
    training replicated on a model>1 mesh, a partial rename included."""
    with pytest.raises(ValueError, match="matched no parameter"):
        mesh_mod.sharding_rules(["encoder_renamed.conv_five.weight"])
    partial = ["enc.conv_five.weight", "bott_bn.weight", "dec.up0.weight"]
    with pytest.raises(ValueError, match=r"enc\.conv5"):
        mesh_mod.sharding_rules(partial)
    names = ["enc.conv5.weight", "bott_bn.weight", "bott_bn.running_mean",
             "dec.up0.weight", "dec.up0.bias", "dec.up1.weight"]
    assert mesh_mod.sharding_rules(names) == {
        "enc.conv5.weight": "enc.conv5", "bott_bn.weight": "bott_bn",
        "bott_bn.running_mean": "bott_bn",
        "dec.up0.weight": "dec.up0.weight"}


def test_tp_shards_video3d_5d_weights(world4):
    """The 3-D family's 5-D bottleneck weights, (nB, cin, T, 4, 4) and
    (nB, cout, T, 4, 4), shard the nBottleneck axis and nothing else; its
    bottleneck conv is enc.conv{video3dLevels}."""
    nb = V3D["nBottleneck"]
    for r in world4:
        shapes = r[3]["shapes"]
        assert shapes["enc.conv3.weight"] == (nb // 2, 16, 2, 4, 4)
        assert shapes["dec.up0.weight"] == (nb // 2, 16, 2, 4, 4)
        assert r[3]["gen"]["enc.conv3.weight"].shape == (nb, 16, 2, 4, 4)


def test_tp_video3d_step_matches_replicated(video3d, world4):
    check_against_jax([r[3] for r in world4], video3d[1])


def test_tp_noise_gen_step_matches_jax(noise_center, world2):
    """noiseGen under TP: the nB channels split over the model ranks, the
    nz noise channels on the last one; z drawn for the global batch.  The
    step equals the JAX step on the same z, and the checkpoint layout
    (gathered) is the unsharded one."""
    outs = [r[1] for r in world2]
    kw = noise_center[0]
    nb, nz = kw["nBottleneck"], kw["nz"]
    assert outs[0]["shapes"]["bott_bn.weight"] == (nb // 2,)
    assert outs[1]["shapes"]["bott_bn.weight"] == (nb // 2 + nz,)
    assert outs[1]["shapes"]["dec.up0.weight"] == (nb // 2 + nz, 64, 4, 4)
    assert outs[0]["gen"]["bott_bn.weight"].shape == (nb + nz,)
    check_against_jax(outs, noise_center[2])


def test_global_batch_norm_equals_one_process(world2, bn_inputs):
    """BatchNorm over a process group equals BatchNorm of the whole batch
    in one process: the output rows, the input gradients, the summed
    parameter gradients and the running statistics (the unbiased variance
    over the global count)."""
    x, w, b, r = bn_inputs
    outs = [o[2] for o in world2]
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    rm, rv = torch.zeros(6), torch.ones(6)
    y = F.batch_norm(xt, rm, rv, wt, bt, training=True, momentum=0.1,
                     eps=1e-5)
    (y * torch.from_numpy(r)).sum().backward()
    tol = BN_TOL
    np.testing.assert_allclose(np.concatenate([o["y"] for o in outs]),
                               y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([o["gx"] for o in outs]),
                               xt.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(o["gw"] for o in outs), wt.grad.numpy(),
                               **tol)
    np.testing.assert_allclose(sum(o["gb"] for o in outs), bt.grad.numpy(),
                               **tol)
    for o in outs:
        np.testing.assert_allclose(o["mean"], rm.numpy(), **tol)
        np.testing.assert_allclose(o["var"], rv.numpy(), **tol)


def test_tp_composes_with_the_other_step_options(world2, options_ref):
    """conditionAdv, gradAccum, remat and adamMomentsBf16 together under
    TP-2 equal the JAX step with the same options: metrics, gradients (the
    bf16 moments), parameters, BN statistics; replicas bitwise equal."""
    outs = [r[3] for r in world2]
    assert all(len(o["moments"]) for o in outs)     # bf16 moments, sharded
    check_against_jax(outs, options_ref)
