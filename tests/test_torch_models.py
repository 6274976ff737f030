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
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.checkpoint import convert
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data.synthetic import _texture
from video_filler_tpu_torch.models import build_for_regime, specs_for_regime
from video_filler_tpu_torch.train import step as tstep

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


# --- bf16 parity (the default computeDtype) -----------------------------------

BF16_METRICS = ("errD", "errD_real", "errD_fake", "errG", "errG_l2",
                "errG_total")


def bf16_spreads(regime, kw, batch):
    """Both packages at computeDtype float32 and bfloat16 from the same JAX
    init (PRNGKey(0)) on the same batch: G's train-mode forward on
    ``batch["real"]`` and one train step.  Returns {(side, dtype): (G
    output as f32 numpy, {metric: float})} for side jax|port."""
    out = {}
    for dt in ("float32", "bfloat16"):
        jopt = JaxOpt(**{**kw, "computeDtype": dt})
        state = jax.jit(lambda k: jstep.init_train_state(k, jopt, regime))(
            jax.random.PRNGKey(0))
        gen, _ = jax_build(jopt, regime)
        y, _ = gen.apply(state.params_g, state.state_g,
                         jnp.asarray(batch["real"]), train=True)
        _, m = jax.jit(jstep.make_train_step(jopt, regime))(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(100))
        out[("jax", dt)] = (np.asarray(y, np.float32),
                            {k: float(m[k]) for k in BF16_METRICS})
        popt = Opt(device="cpu", **{**kw, "computeDtype": dt})
        pstate = tstep.init_train_state(popt, regime,
                                        torch.Generator().manual_seed(0))
        sd_g, sd_d = convert.from_jax(state.params_g, state.state_g,
                                      state.params_d, state.state_d)
        pstate.gen.load_state_dict(sd_g, strict=True)
        pstate.disc.load_state_dict(sd_d, strict=True)
        g, _ = build_for_regime(popt, regime)
        g.load_state_dict(sd_g, strict=True)
        with torch.no_grad():
            y = g.train()(torch.from_numpy(batch["real"])).float().numpy()
        m = tstep.make_train_step(popt, regime)(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        out[("port", dt)] = (y, {k: m[k].item() for k in BF16_METRICS})
    return out


def check_bf16_parity(out):
    """The three bf16 assertions, every tolerance derived from the measured
    bf16-vs-f32 spreads: (1) the port's G error against its own f32 output,
    mean and max abs, at most 1.5x JAX's; (2) port against JAX in bf16, max
    abs, at most 2x the larger of the two packages' max errors; (3) each
    one-step metric of the port within 2x the larger of the two packages'
    relative bf16-vs-f32 change of that metric of JAX's bf16 value."""
    err = {side: np.abs(out[(side, "bfloat16")][0] - out[(side, "float32")][0])
           for side in ("jax", "port")}
    assert err["port"].mean() <= 1.5 * err["jax"].mean()
    assert err["port"].max() <= 1.5 * err["jax"].max()
    cross = np.abs(out[("port", "bfloat16")][0] - out[("jax", "bfloat16")][0])
    assert cross.max() <= 2 * max(err["jax"].max(), err["port"].max())
    for k in BF16_METRICS:
        spread = max(abs(out[(side, "bfloat16")][1][k]
                         / out[(side, "float32")][1][k] - 1)
                     for side in ("jax", "port"))
        np.testing.assert_allclose(out[("port", "bfloat16")][1][k],
                                   out[("jax", "bfloat16")][1][k],
                                   rtol=2 * spread, err_msg=k)


def test_bf16_center_parity_at_batch_8():
    """ROADMAP C.1, center.  Measured on the CPU at nef=ngf=ndf=8,
    nBottleneck 16, batch 8 (smooth textures): G's bf16-vs-f32 error is
    7.19e-4 mean / 7.54e-3 max abs for JAX and 6.46e-4 / 6.69e-3 for the
    port; port against JAX in bf16 6.36e-4 / 7.32e-3.  The one-step errD
    moves 6.1e-4 (JAX) and 3.7e-4 (port) relative from f32 to bf16, and
    the two packages' bf16 errD differ by 9.8e-4; errG_l2 4.4e-5 / 3.8e-5
    against 7.1e-6.  No gap at batch 2 either: 4.13e-4 JAX, 4.09e-4 port
    (ROADMAP §C)."""
    rs = np.random.RandomState(1)
    real = np.stack([_texture(rs, 128, 128) for _ in range(8)]).astype(
        np.float32) / 127.5 - 1.0
    check_bf16_parity(bf16_spreads(
        "center", dict(SMALL, batchSize=8, wtl2=0.999, overlapPred=4),
        {"real": real}))


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


def _jax_option_nets(regime, seed, **kw):
    """A JAX (G, D) pair of a 2-D regime with options ``kw`` at SMALL widths,
    its parameters with every conv bias drawn nonzero, N(0, 0.02) as the
    weights (so that a bias added in the wrong place, or not at all,
    shows), and the port's pair loaded from them."""
    jopt = JaxOpt(**{**SMALL, **kw})
    gen, disc = jax_build(jopt, regime)
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)

    def bias(path, leaf):
        if path[-1].key == "b":
            return jnp.asarray(rs.normal(0, 0.02, leaf.shape), jnp.float32)
        return leaf
    jg = [jax.jit(gen.init)(kg), jax.jit(disc.init)(kd)]
    jg = [(jax.tree_util.tree_map_with_path(bias, p), s_) for p, s_ in jg]
    g, d = build_for_regime(Opt(device="cpu", **{**SMALL, **kw}), regime)
    sd_g, sd_d = convert.from_jax(jg[0][0], jg[0][1], jg[1][0], jg[1][1])
    g.load_state_dict(sd_g, strict=True)
    d.load_state_dict(sd_d, strict=True)
    return gen, disc, jg[0], jg[1], g, d


@pytest.mark.parametrize("case", ["center_useBias", "center_conditionAdv",
                                  "center_noiseGen"])
def test_option_models_match_jax(case):
    """The model options the port once refused, in train mode against the
    JAX models from the same parameters: G with conv biases, the
    conditionAdv D on (ctx, pred), the noiseGen G on (ctx, z).  (video3d
    with conv biases: tests/test_torch_video3d.py.)"""
    regime, option = case.split("_")
    kw = {"noiseGen": dict(noiseGen=True, nz=5)}.get(option, {option: True})
    gen, disc, jg, jd, g, d = _jax_option_nets(regime, 3, **kw)
    rs = np.random.RandomState(4)
    ctx, center = _inputs(4)
    if case == "center_useBias":
        net, ours_net = gen, g
        jx, tx = jnp.asarray(ctx), torch.from_numpy(ctx)
        assert g.enc.conv0.bias.shape == (8,) and d.conv5.bias.shape == (1,)
    elif case == "center_conditionAdv":
        net, ours_net = disc, d
        jx = (jnp.asarray(ctx), jnp.asarray(center))
        tx = (torch.from_numpy(ctx), torch.from_numpy(center))
    else:
        net, ours_net = gen, g
        z = rs.normal(size=(2, 1, 1, 5)).astype(np.float32)
        jx = (jnp.asarray(ctx), jnp.asarray(z))
        tx = (torch.from_numpy(ctx), torch.from_numpy(z))
    params, state = jg if net is gen else jd
    ref, ref_state = net.apply(params, state, jx, train=True)
    ours = ours_net.train()(tx)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)
    _, st = convert.state_dict_to_tree(ours_net.state_dict())
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(ref_state)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


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
