"""The port's sequence parallelism for video3d (video_filler_tpu_torch/
parallel/temporal.py): halo-exchange convs against the unsharded ones and
the SP train step against the JAX package's, in one gloo world of 4
processes on the CPU (the counterpart of tests/test_temporal_sp.py).
Tolerances as there: metrics rtol 1e-4 / atol 1e-5, parameters after the
first Adam step atol 4.1e-3, BN state rtol 1e-4 / atol 1e-5; the convs'
values and gradients rtol 1e-4 / atol 1e-4; the step's gradients, as
Adam's first moments, within 0.1 of each leaf's largest value
(test_torch_parallel.py says why)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_workers as workers
from test_torch_parallel import _case, _jax_case, check_against_jax
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.parallel.launch import run_world
from video_filler_tpu_torch.parallel.mesh import Coords
from video_filler_tpu_torch.parallel.temporal import (
    check_frame_split,
    shard_sp_batch,
    shard_sp_host_batch,
)
from video_filler_tpu_torch.train import step as tstep

V3D = dict(nef=8, ngf=8, ndf=8, nBottleneck=64, predLen=4, batchSize=4,
           wtl2=0.999, weight_nomask=0.05, computeDtype="float32",
           video3dLevels=3, fineSize=32)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


def _clip_batch(b, seed):
    rs = np.random.RandomState(seed)
    mask = np.zeros((b, 1, 32, 32, 1), np.float32)
    mask[:, :, 8:20, 8:20] = 1.0
    return {"real": rs.rand(b, 4, 32, 32, 3).astype(np.float32) * 2 - 1,
            "mask": mask}


@pytest.fixture(scope="module")
def conv_inputs():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 4, 8, 8, 8).astype(np.float32)        # (B,C,T,H,W)
    w = (rs.randn(6, 4, 3, 4, 4) * 0.1).astype(np.float32)
    wt = (rs.randn(4, 6, 3, 4, 4) * 0.1).astype(np.float32)
    r = rs.randn(2, 6, 8, 4, 4).astype(np.float32)
    rt = rs.randn(2, 6, 8, 16, 16).astype(np.float32)
    return x, w, wt, r, rt


@pytest.fixture(scope="module")
def sp_ref():
    batch = _clip_batch(4, 3)
    return batch, _jax_case("video3d", V3D, batch, seed=7)


ACCUM = dict(V3D, batchSize=8, gradAccum=2)
# withInit (the composite at weight_nomask 0): the replicated initializer,
# the JAX init's G, runs on the whole clip, each seq rank keeping its frames
WITH_INIT = dict(V3D, weight_nomask=0.0)


@pytest.fixture(scope="module")
def accum_ref():
    batch = _clip_batch(8, 0)
    return batch, _jax_case("video3d", ACCUM, batch, seed=8)


@pytest.fixture(scope="module")
def init_ref():
    batch = _clip_batch(4, 5)
    return batch, _jax_case("video3d", WITH_INIT, batch, seed=9,
                            with_init=True)


@pytest.fixture(scope="module")
def world(conv_inputs, sp_ref, accum_ref, init_ref):
    """One gloo world of 4: the halo convs over seq 4; the SP step on data
    2 x seq 2; the SP step at gradAccum 2; the SP step with withInit."""
    cases = [_case(ref, "video3d", kw, batch, 2, 2, "seq")
             for kw, (batch, ref) in ((V3D, sp_ref), (ACCUM, accum_ref),
                                      (WITH_INIT, init_ref))]
    return run_world(4, workers.many, ([
        ("sp_convs", conv_inputs),
        *(("sharded_step", (c,)) for c in cases),
    ],), device="cpu", timeout_s=120)


def _plain(x, w, wt, r, rt):
    out = {}
    for name, fn, weight, rr in (
            ("conv", lambda x, w: F.conv3d(x, w, stride=(1, 2, 2),
                                           padding=1), w, r),
            ("convt", lambda x, w: F.conv_transpose3d(
                x, w, stride=(1, 2, 2), padding=1), wt, rt)):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt_ = torch.from_numpy(weight).requires_grad_(True)
        y = fn(xt, wt_)
        (y * torch.from_numpy(rr)).sum().backward()
        out[name] = {"y": y.detach().numpy(), "gx": xt.grad.numpy(),
                     "gw": wt_.grad.numpy()}
    return out


@pytest.mark.parametrize("name", ["conv", "convt"])
def test_halo_convs_match_unsharded_with_grads(world, conv_inputs, name):
    """SPConv3d / SPConvTranspose3d over 4 seq shards of T=8 equal the
    plain conv3d / conv_transpose3d: values (the boundary shards' zero
    halos are the temporal padding), input gradients (the halo gradients
    sent back onto the boundary frames) and weight gradients (summed over
    the shards)."""
    ref = _plain(*conv_inputs)[name]
    outs = [r[0][name] for r in world]
    np.testing.assert_allclose(np.concatenate([o["y"] for o in outs], 2),
                               ref["y"], **CONV_TOL)
    np.testing.assert_allclose(np.concatenate([o["gx"] for o in outs], 2),
                               ref["gx"], **CONV_TOL)
    np.testing.assert_allclose(sum(o["gw"] for o in outs), ref["gw"],
                               **CONV_TOL)


def test_halo_boundary_frames_see_zero_padding(world, conv_inputs):
    """The clip's first and last frames depend on the zero halos: compare
    them on their own, as the JAX test does."""
    ref = _plain(*conv_inputs)["conv"]["y"]
    outs = [r[0]["conv"]["y"] for r in world]
    np.testing.assert_allclose(outs[0][:, :, 0], ref[:, :, 0], **CONV_TOL)
    np.testing.assert_allclose(outs[-1][:, :, -1], ref[:, :, -1], **CONV_TOL)


def test_sp_train_step_matches_unsharded(world, sp_ref):
    """The whole SP video3d step (halo convs, the T-gathered bottleneck
    split over seq, up0 reduce-scattered over T, BN over data x seq) equals
    the JAX package's unsharded step."""
    outs = [r[1] for r in world]
    assert [o["coords"] for o in outs] == [(2, 0, 2, 0), (2, 0, 2, 1),
                                           (2, 1, 2, 0), (2, 1, 2, 1)]
    assert outs[0]["shapes"]["enc.conv3.weight"][0] == V3D["nBottleneck"] // 2
    check_against_jax(outs, sp_ref[1])


def test_sp_composes_with_grad_accum(world, accum_ref):
    """SP and gradAccum compose: the microbatches run on the seq-sharded
    clips and the step equals the JAX package's gradAccum step."""
    outs = [r[2] for r in world]
    assert outs[0]["step"] == 1
    check_against_jax(outs, accum_ref[1])


def test_sp_host_batch_layout_matches_plain():
    """The loop's SP path -- a seq rank's frames cut from the uint8 folded
    batch, then the preprocess with the global batch's decisions -- gives
    the step batch that the plain preprocess of the whole clip, sharded,
    gives; each shard holds whole frames."""
    opt = Opt(device="cpu", **V3D)
    rs = np.random.RandomState(3)
    host = {"raw": torch.from_numpy(
                rs.randint(0, 256, (4, 40, 40, 3 * opt.predLen), np.uint8)),
            "mask": torch.from_numpy(np.zeros((4, 40, 40, 1), np.uint8))}
    host["mask"][:, 8:20, 8:20] = 1
    full = tstep.make_preprocess(opt, "video3d")(
        host, gen=torch.Generator().manual_seed(11))
    local_pre = tstep.make_preprocess(opt.replace(predLen=2), "video3d")
    for d in range(2):
        for s in range(2):
            where = Coords(2, d, "seq", 2, s)
            rows = {k: v[2 * d:2 * d + 2] for k, v in host.items()}
            mine = shard_sp_host_batch(where, rows, nc=3)
            assert mine["raw"].shape[-1] == 3 * opt.predLen // 2
            draws = tstep.global_draws(opt, "video3d",
                                       torch.Generator().manual_seed(11),
                                       tuple(mine["raw"].shape), 2, d)
            got = local_pre(mine, draws=draws)
            want = shard_sp_batch(where, full)
            for k in ("real", "mask"):
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_sp_host_batch_rejects_mid_frame_split():
    """n_seq dividing the FOLDED channel count is not enough: nc=3, T=4,
    n_seq=6 divides 12 but would shard mid-frame; the guard checks frame
    alignment (n_seq | T), loudly."""
    with pytest.raises(ValueError, match="frame count"):
        check_frame_split(12, 6, 3)
    with pytest.raises(ValueError, match="frame count"):
        shard_sp_host_batch(Coords(1, 0, "seq", 6, 0),
                            {"raw": torch.zeros(2, 8, 8, 12,
                                                dtype=torch.uint8)})
    assert check_frame_split(12, 2, 3) == 6


def test_sp_composes_with_with_init(world, init_ref):
    """withInit under SP (the composite at weight_nomask 0) equals the JAX
    package's withInit step."""
    check_against_jax([r[3] for r in world], init_ref[1])
