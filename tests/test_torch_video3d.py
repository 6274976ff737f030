"""The temporal 3-D family (regime=video3d) of the port against the JAX
package's: its layers, generator and discriminator, the 5-D checkpoint
conversion and the preprocess, on numpy inputs made from a seed, at the
small widths of the JAX suite's own 3-D tests (tests/test_video3d.py:20-22:
nef=ngf=ndf=8, nBottleneck 32, video3dLevels 3, fineSize 32).

Tolerances: single layers rtol 1e-4 / atol 1e-4 (the JAX suite's own for
its 3-D convs against torch); whole networks and BN running statistics
rtol 1e-3 / atol 1e-5 (tests/test_torch_models.py); fold/unfold, the
conversion round trip and the preprocess exact.  Inputs are zero-mean:
the JAX BatchNorm's one-pass variance loses f32 digits on an offset mean
(ROADMAP §C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.models import build_for_regime as jax_build
from video_filler_tpu.ops import layers3d as jlayers3d
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.checkpoint import convert
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.models import (
    Video3DSpec,
    build_for_regime,
    check_fine_size,
    video3d_fine_size,
)
from video_filler_tpu_torch.models.context_encoder_3d import (
    Discriminator3D,
    Generator3D,
)
from video_filler_tpu_torch.ops import layers3d
from video_filler_tpu_torch.train import step as tstep

torch.set_num_threads(1)

TINY = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, batchSize=2, fineSize=32,
            video3dLevels=3, predLen=2, computeDtype="float32")
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)
NET_TOL = dict(rtol=1e-3, atol=1e-5)


def _clip(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _weights(shape, seed):
    return (0.02 * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _ncdhw(x):
    """(B,T,H,W,C) numpy -> the layers' NCDHW channels-last-3d tensor."""
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _ndhwc(t):
    return t.permute(0, 2, 3, 4, 1).detach().numpy()


# --- layers ---------------------------------------------------------------

CONV_CASES = {
    # name: (cin, cout, kernel, stride, padding, input (B,T,H,W,C))
    "ladder": (3, 4, (3, 4, 4), (1, 2, 2), (1, 1, 1), (2, 4, 8, 8, 3)),
    "valid_head": (5, 7, (2, 4, 4), (1, 1, 1), (0, 0, 0), (2, 2, 4, 4, 5)),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv3d_matches_jax(case):
    cin, cout, k, s, p, shape = CONV_CASES[case]
    w = _weights(k + (cin, cout), 1)                       # DHWIO
    x = _clip(shape, 2)
    ref, _ = jlayers3d.conv3d(cin, cout, k, s, p, dtype=jnp.float32).apply(
        {"w": jnp.asarray(w)}, {}, jnp.asarray(x))
    layer = layers3d.Conv3d(cin, cout, k, s, p, torch.float32)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            convert.to_torch_layout(("enc", "conv0", "w"), w)))
    np.testing.assert_allclose(_ndhwc(layer(_ncdhw(x))), np.asarray(ref),
                               **LAYER_TOL)


TRANSPOSE_CASES = {
    # the general path (input-dilated, reversed kernel) and the JAX 1x1x1
    # bottleneck path (an einsum)
    "general": (5, 3, (3, 4, 4), (1, 2, 2), (1, 1, 1), (2, 4, 4, 4, 5)),
    "bottleneck_1x1x1": (6, 4, (2, 4, 4), (1, 1, 1), (0, 0, 0),
                         (2, 1, 1, 1, 6)),
}


@pytest.mark.parametrize("case", list(TRANSPOSE_CASES))
def test_conv3d_transpose_matches_jax(case):
    cin, cout, k, s, p, shape = TRANSPOSE_CASES[case]
    w = _weights(k + (cin, cout), 3)                       # (kt,kh,kw,ci,co)
    x = _clip(shape, 4)
    ref, _ = jlayers3d.conv3d_transpose(cin, cout, k, s, p,
                                        dtype=jnp.float32).apply(
        {"w": jnp.asarray(w)}, {}, jnp.asarray(x))
    layer = layers3d.ConvTranspose3d(cin, cout, k, s, p, torch.float32)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            convert.to_torch_layout(("dec", "up0", "w"), w)))
    got = _ndhwc(layer(_ncdhw(x)))
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), **LAYER_TOL)


def test_fold_and_unfold_time_match_jax():
    x = _clip((2, 3, 8, 6, 3), 5)
    folded = layers3d.fold_time(torch.from_numpy(x))
    ref = np.array(jlayers3d.fold_time(jnp.asarray(x)))
    assert folded.shape == (2, 8, 6, 9)
    np.testing.assert_array_equal(folded.numpy(), ref)
    # frame-major channels: frame t holds channels [3t, 3t+3)
    np.testing.assert_array_equal(folded[..., 3:6].numpy(), x[:, 1])
    y = layers3d.unfold_time(torch.from_numpy(ref), 3)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jlayers3d.unfold_time(jnp.asarray(ref), 3)))
    np.testing.assert_array_equal(y.numpy(), x)


# --- models ---------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    """JAX G and D of the tiny configuration, initialised once (jitted: the
    eager init of the 3-D trees compiles each leaf's draw), and the port's
    pair with those weights."""
    jopt = JaxOpt(**TINY)
    jg, jd = jax_build(jopt, "video3d")
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    pg, pd = jax.jit(jg.init)(kg), jax.jit(jd.init)(kd)
    g, d = build_for_regime(Opt(device="cpu", **TINY), "video3d")
    sd_g, sd_d = convert.from_jax(pg[0], pg[1], pd[0], pd[1])
    return jg, jd, pg, pd, g, d, sd_g, sd_d


def _fresh(module, sd):
    module.load_state_dict(sd, strict=True)
    return module


def _check_state(module, ref_state):
    _, state = convert.state_dict_to_tree(module.state_dict())
    la, ta = jax.tree.flatten(state)
    lb, tb = jax.tree.flatten(ref_state)
    assert ta == tb
    for a, b in zip(la, lb):
        np.testing.assert_allclose(a, np.asarray(b), **NET_TOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_generator3d_forward_matches_jax(nets, train):
    jg, _, pg, _, g, _, sd_g, _ = nets
    x = _clip((2, 2, 32, 32, 3), 6)
    ref, ref_state = jg.apply(pg[0], pg[1], jnp.asarray(x), train=train)
    out = _fresh(g, sd_g).train(train)(torch.from_numpy(x))
    assert out.shape == (2, 2, 32, 32, 3) and out.is_contiguous()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **NET_TOL)
    _check_state(g, ref_state)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_discriminator3d_forward_matches_jax(nets, train):
    _, jd, _, pd, _, d, _, sd_d = nets
    x = _clip((2, 2, 32, 32, 3), 7)
    ref, ref_state = jd.apply(pd[0], pd[1], jnp.asarray(x), train=train)
    out = _fresh(d, sd_d).train(train)(torch.from_numpy(x))
    assert out.shape == (2,)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **NET_TOL)
    _check_state(d, ref_state)
    assert "bn0.weight" not in sd_d and "bn1.weight" not in sd_d
    assert "bn2.weight" in sd_d


def test_full_width_trees_match_the_jax_shapes():
    """At full width (the chip's configuration) every JAX leaf maps through
    convert to the port's tensor of the same name and shape; the models are
    built on the meta device, so nothing is allocated."""
    full = dict(predLen=4, nBottleneck=4000, computeDtype="bfloat16")
    jg, jd = jax_build(JaxOpt(**full), "video3d")
    with torch.device("meta"):
        g, d = build_for_regime(Opt(device="cpu", **full), "video3d")
    for jnet, net in ((jg, g), (jd, d)):
        params, state = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
        shapes = {}
        for tree, is_state in ((params, False), (state, True)):
            for path, leaf in convert._flatten(tree):
                view = np.broadcast_to(np.float32(0), leaf.shape)
                if not is_state:
                    view = convert.to_torch_layout(path, view)
                name = (convert._STATE_LEAF if is_state
                        else convert._PARAM_LEAF)[path[-1]]
                key = ".".join(path[:-1] + (name,))
                shapes[key] = view.shape
                assert convert.jax_path(key, view.ndim) == (is_state, path)
        assert shapes == {k: tuple(v.shape)
                          for k, v in net.state_dict().items()}
    n_g = sum(p.numel() for p in g.parameters())
    assert n_g == 279_082_688        # two 131 M bottleneck layers
    assert g.enc.conv5.weight.shape == (4000, 512, 4, 4, 4)
    assert g.dec.up0.weight.shape == (4000, 512, 4, 4, 4)
    assert g.dec.up5.weight.shape == (64, 3, 3, 4, 4)


def test_bf16_compute_keeps_params_f32_and_output_contiguous(nets):
    g, d = build_for_regime(Opt(device="cpu", **dict(
        TINY, computeDtype="bfloat16")), "video3d")
    fake = g.train()(torch.from_numpy(_clip((2, 2, 32, 32, 3), 8)))
    assert fake.dtype == torch.bfloat16 and fake.is_contiguous()
    assert all(p.dtype == torch.float32 for p in g.parameters())
    assert d.train()(fake).dtype == torch.bfloat16


def test_a_wrong_clip_shape_raises():
    g = Generator3D(Video3DSpec(**dict(nef=8, ngf=8, ndf=8, n_bottleneck=32,
                                       levels=3, pred_len=2,
                                       dtype="float32")))
    d = Discriminator3D(g.spec)
    for shape in ((2, 2, 64, 64, 3), (2, 3, 32, 32, 3), (2, 32, 32, 6)):
        for net in (g, d):
            with pytest.raises(ValueError, match="4\\*2\\*\\*video3dLevels"):
                net(torch.zeros(shape))


# --- checkpoint conversion ------------------------------------------------

def _leaves_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_convert_5d_round_trip_is_exact(nets):
    _, _, pg, pd, _, _, sd_g, sd_d = nets
    # DHWIO -> OIDHW; (kt,kh,kw,cin,cout) -> (cin,cout,kt,kh,kw)
    assert sd_g["enc.conv0.weight"].shape == (8, 3, 3, 4, 4)
    assert sd_g["enc.conv3.weight"].shape == (32, 16, 2, 4, 4)
    assert sd_g["dec.up0.weight"].shape == (32, 16, 2, 4, 4)
    assert sd_g["dec.up3.weight"].shape == (8, 3, 3, 4, 4)
    w = np.asarray(pg[0]["enc"]["conv0"]["w"])
    np.testing.assert_array_equal(sd_g["enc.conv0.weight"].numpy(),
                                  w.transpose(4, 3, 0, 1, 2))
    w = np.asarray(pg[0]["dec"]["up1"]["w"])
    np.testing.assert_array_equal(sd_g["dec.up1.weight"].numpy(),
                                  w.transpose(3, 4, 0, 1, 2))
    # the BN leaves keep their names: a 5-D weight is no gamma
    params, _ = convert.state_dict_to_tree(sd_g)
    assert set(params["enc"]["conv1"]) == {"w"}
    assert set(params["enc"]["bn1"]) == {"gamma", "beta"}
    assert convert.jax_path("enc.conv1.weight", 5) == (False,
                                                      ("enc", "conv1", "w"))
    back = convert.to_jax(sd_g, sd_d)
    for ours, ref in zip(back, (pg[0], pg[1], pd[0], pd[1])):
        _leaves_equal(ours, ref)


def test_convert_4d_results_are_unchanged():
    """The 2-D mappings, bit for bit: HWIO -> OIHW by (3,2,0,1), the
    transposed (k,k,cin,cout) -> (cin,cout,k,k) by (2,3,0,1), and back."""
    rs = np.random.RandomState(9)
    w = rs.randn(4, 4, 3, 8).astype(np.float32)
    for path, perm, inv in ((("enc", "conv0", "w"), (3, 2, 0, 1),
                             (2, 3, 1, 0)),
                            (("dec", "up0", "w"), (2, 3, 0, 1),
                             (2, 3, 0, 1))):
        t = convert.to_torch_layout(path, w)
        np.testing.assert_array_equal(t, w.transpose(perm))
        np.testing.assert_array_equal(convert.to_jax_layout(path, t),
                                      t.transpose(inv))
    g = rs.randn(8).astype(np.float32)
    assert convert.to_torch_layout(("enc", "bn1", "gamma"), g) is g
    assert convert.jax_path("enc.conv0.weight", 4) == (False,
                                                      ("enc", "conv0", "w"))
    assert convert.jax_path("enc.bn1.weight", 1) == (False,
                                                    ("enc", "bn1", "gamma"))


# --- preprocess and options -----------------------------------------------

def test_video3d_preprocess_matches_jax_with_its_decisions():
    rs = np.random.RandomState(10)
    raw = rs.randint(0, 256, (2, 50, 60, 6), np.uint8)
    mask = np.zeros((2, 50, 60, 1), np.uint8)
    mask[0, 10:40, 20:50] = 1             # sample 1: empty, random blocks
    key = jax.random.PRNGKey(11)
    ref = jstep.make_preprocess(JaxOpt(**TINY), "video3d")(
        {"raw": jnp.asarray(raw), "mask": jnp.asarray(mask)}, key)
    k_crop, k_blk, k_flip = jax.random.split(key, 3)
    ky, kx = jax.random.split(k_crop)
    bs = 32 // 6
    kn, kby, kbx = jax.random.split(k_blk, 3)

    def t(a):
        return torch.from_numpy(np.array(a))

    draws = {"y0": t(jax.random.randint(ky, (2,), 0, 50 - 32)),
             "x0": t(jax.random.randint(kx, (2,), 0, 60 - 32)),
             "flip": t(jax.random.uniform(k_flip, (2,)) < 0.5),
             "blocks": {"n_blocks": t(jax.random.randint(kn, (2,), 2, 11)),
                        "tly": t(jax.random.randint(kby, (2, 10), 2,
                                                    32 - bs - 2)),
                        "tlx": t(jax.random.randint(kbx, (2, 10), 2,
                                                    32 - bs - 2))}}
    make = tstep.make_preprocess(Opt(device="cpu", **TINY), "video3d")
    ours = make({"raw": torch.from_numpy(raw), "mask": torch.from_numpy(mask)},
                draws=draws)
    assert ours["real"].shape == (2, 2, 32, 32, 3)
    assert ours["real"].is_contiguous()
    assert ours["mask"].shape == (2, 1, 32, 32, 1)
    for k in ("real", "mask"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_fine_size_must_match_the_levels():
    assert video3d_fine_size(Opt(device="cpu")) == 128
    assert video3d_fine_size(Opt(device="cpu", video3dLevels=3)) == 32
    check_fine_size(Opt(device="cpu", **TINY), "video3d")
    check_fine_size(Opt(device="cpu", fineSize=64), "video")
    bad = Opt(device="cpu", **dict(TINY, fineSize=64))
    with pytest.raises(ValueError, match="fineSize=64 with video3dLevels=3"):
        check_fine_size(bad, "video3d")
    with pytest.raises(ValueError, match="fineSize"):
        tstep.make_train_step(bad, "video3d")
    with pytest.raises(ValueError, match="fineSize"):
        tstep.make_preprocess(bad, "video3d")


@pytest.mark.parametrize("kw,exc,match", [
    (dict(seqParallel=3), ValueError, "predLen 2 must divide by "
                                      "seqParallel 3"),
    (dict(noiseGen=True), ValueError, "video3d has neither"),
    (dict(conditionAdv=True), ValueError, "video3d has neither"),
], ids=["seqParallel", "noiseGen", "conditionAdv"])
def test_options_the_3d_family_refuses(kw, exc, match):
    with pytest.raises(exc, match=match):
        build_for_regime(Opt(device="cpu", **TINY, **kw), "video3d")


def test_use_bias_generator3d_matches_jax():
    """useBias on the 3-D family: every conv of G and D has a bias (JAX
    leaf ``b``), added after the conv; with the biases drawn nonzero, G's
    train-mode forward and running statistics match the JAX G's.  The
    biases are drawn N(0, 0.02), the weights' scale: at N(0, 0.1) the
    offset they give the BatchNorms' inputs costs the JAX layers' one-pass
    variance f32 digits (ROADMAP §C; G's output 5.2e-5 off a float64
    forward, the port's 6.4e-6)."""
    jopt = JaxOpt(**{**TINY, "useBias": True})
    jg, jd = jax_build(jopt, "video3d")
    kg, kd = jax.random.split(jax.random.PRNGKey(1))
    (gp, gs), (dp, ds) = jax.jit(jg.init)(kg), jax.jit(jd.init)(kd)
    rs = np.random.RandomState(2)
    gp = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rs.normal(0, 0.02, x.shape), jnp.float32)
        if p[-1].key == "b" else x, gp)
    g, d = build_for_regime(Opt(device="cpu", **TINY, useBias=True),
                            "video3d")
    sd_g, sd_d = convert.from_jax(gp, gs, dp, ds)
    assert sd_g["dec.up3.bias"].shape == (3,) and "conv3.bias" in sd_d
    g.load_state_dict(sd_g, strict=True)
    d.load_state_dict(sd_d, strict=True)
    x = _clip((2, 2, 32, 32, 3), 6)
    ref, ref_state = jg.apply(gp, gs, jnp.asarray(x), train=True)
    out = g.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **NET_TOL)
    _check_state(g, ref_state)
