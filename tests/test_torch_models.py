"""Center-regime G and D of the port against the JAX package's, with the JAX
parameters carried over by checkpoint/convert.

Tolerances: the conversion round trip is exact; forwards and BN running
statistics rtol 1e-3 / atol 1e-5 (tests/test_step_golden.py's bound for
torch against JAX through a whole network in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.models import build_for_regime as jax_build
from video_filler_tpu.ops import masks as jmasks
from video_filler_tpu_torch.checkpoint import convert
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.models import build_for_regime, specs_for_regime

torch.set_num_threads(1)

SMALL = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=2,
             computeDtype="float32")
TOL = dict(rtol=1e-3, atol=1e-5)


def _jax_nets(seed=0):
    gen, disc = jax_build(JaxOpt(**SMALL), "center")
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    return gen, disc, gen.init(kg), disc.init(kd)


def _port_nets(jg, jd):
    g, d = build_for_regime(Opt(device="cpu", **SMALL), "center")
    sd_g, sd_d = convert.from_jax(jg[0], jg[1], jd[0], jd[1])
    g.load_state_dict(sd_g, strict=True)
    d.load_state_dict(sd_d, strict=True)
    return g, d


def _leaves_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_convert_round_trip_is_exact():
    _, _, (gp, gs), (dp, ds) = _jax_nets()
    sd_g, sd_d = convert.from_jax(gp, gs, dp, ds)
    assert sd_g["enc.conv0.weight"].shape == (8, 3, 4, 4)          # OIHW
    assert sd_g["dec.up0.weight"].shape == (16, 64, 4, 4)          # cin,cout
    assert sd_g["bott_bn.running_var"].shape == (16,)
    back = convert.to_jax(sd_g, sd_d)
    for ours, ref in zip(back, (gp, gs, dp, ds)):
        _leaves_equal(ours, ref)


def test_state_dict_keys_cover_the_port_models():
    _, _, jg, jd = _jax_nets()
    g, d = _port_nets(jg, jd)
    sd_g, sd_d = convert.from_jax(jg[0], jg[1], jd[0], jd[1])
    assert set(sd_g) == set(g.state_dict())
    assert set(sd_d) == set(d.state_dict())


def _inputs(seed=3):
    real = np.random.RandomState(seed).rand(2, 128, 128, 3).astype(
        np.float32) * 2 - 1
    ctx = np.array(jmasks.center_mask_fill(jnp.asarray(real), 4))
    return ctx, np.ascontiguousarray(real[:, 32:96, 32:96])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_generator_forward_matches_jax(train):
    gen, _, jg, jd = _jax_nets(1)
    g, _ = _port_nets(jg, jd)
    ctx, _ = _inputs()
    ref, ref_state = gen.apply(jg[0], jg[1], jnp.asarray(ctx), train=train)
    ours = g.train(train)(torch.from_numpy(ctx))
    assert ours.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)
    _, state = convert.state_dict_to_tree(g.state_dict())
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(ref_state)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_discriminator_forward_matches_jax(train):
    _, disc, jg, jd = _jax_nets(2)
    _, d = _port_nets(jg, jd)
    _, center = _inputs(4)
    ref, ref_state = disc.apply(jd[0], jd[1], jnp.asarray(center),
                                train=train)
    ours = d.train(train)(torch.from_numpy(center))
    assert ours.shape == (2,)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)
    _, state = convert.state_dict_to_tree(d.state_dict())
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(ref_state)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_bf16_compute_keeps_params_f32():
    g, d = build_for_regime(Opt(device="cpu", **dict(
        SMALL, computeDtype="bfloat16")), "center")
    ctx, center = _inputs(5)
    fake = g.train()(torch.from_numpy(ctx))
    assert fake.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in g.parameters())
    assert d.train()(fake).dtype == torch.bfloat16


def test_reference_init_from_a_generator():
    opt = Opt(device="cpu", **dict(SMALL, nef=64, ngf=64, nBottleneck=100))
    g1, _ = build_for_regime(opt, "center", torch.Generator().manual_seed(3))
    g2, _ = build_for_regime(opt, "center", torch.Generator().manual_seed(3))
    for a, b in zip(g1.state_dict().values(), g2.state_dict().values()):
        assert torch.equal(a, b)
    w = g1.enc.conv3.weight.detach()
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    gamma = g1.enc.bn3.weight.detach()
    assert abs(float(gamma.mean()) - 1.0) < 0.01
    assert torch.equal(g1.enc.bn3.bias, torch.zeros_like(g1.enc.bn3.bias))


@pytest.mark.parametrize("regime,kw,item", [
    ("video3d", {"useBias": True}, "A.8"),
    ("center", {"conditionAdv": True}, "A.8"),
    ("center", {"noiseGen": True}, "A.8"),
])
def test_unported_regimes_and_options_raise(regime, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        specs_for_regime(Opt(device="cpu", **kw), regime)


# regime -> (G in, G out, mid width, D in) at predLen 4, ngf 64
PORTED = {"video": (12, 12, 64, 12), "logo": (3, 3, 32, 3),
          "wholeim": (108, 12, 64, 12)}


@pytest.mark.parametrize("regime", list(PORTED))
def test_ported_regimes_have_the_jax_specs(regime):
    from video_filler_tpu.models import specs_for_regime as jax_specs
    g, d = specs_for_regime(Opt(device="cpu", predLen=4), regime)
    jg, jd = jax_specs(JaxOpt(predLen=4), regime)
    nc_in, nc_out, mid, d_in = PORTED[regime]
    assert (g.nc_in, g.nc_out, g.out_size, d.nc_in, d.in_size) == \
        (nc_in, nc_out, 128, d_in, 128)
    assert (g.mid_channels or g.ngf) == mid
    for ours, ref in ((g, jg), (d, jd)):
        for f in ("nc_in", "ndf", "in_size", "nc_out", "nef", "ngf",
                  "n_bottleneck", "out_size", "mid_channels", "dtype"):
            assert getattr(ours, f, None) == getattr(ref, f, None), f


def test_entry_is_the_flagship_video_generator_in_eval_mode():
    """``entry()`` mirrors ``__graft_entry__.entry()``: the 128-out video
    generator at predLen 4, nBottleneck 4000, batch 8, bf16, eval mode."""
    from video_filler_tpu_torch.entry import entry
    gen, (x,) = entry("cpu")
    assert x.shape == (8, 128, 128, 12) and x.device.type == "cpu"
    assert not gen.training
    assert not any(p.requires_grad for p in gen.parameters())
    assert gen.enc.conv5.weight.shape == (4000, 512, 4, 4)
    assert gen.dec.up5.weight.shape == (64, 12, 4, 4)
    y = gen(x)
    assert y.shape == (8, 128, 128, 12) and y.dtype == torch.bfloat16
    assert bool(torch.isfinite(y.float()).all())
