"""The video slice's ops, models and preprocess against the JAX package's,
on the same numpy inputs, with the JAX side's random draws passed in.

Tolerances: mask ops, random blocks and the preprocess exact;
mask_l2_weights, masked_mse and gdl rtol 1e-5; the 128-out generators and
128-in discriminators rtol 1e-5 / atol 1e-5 in f32 (the atol covers
outputs near zero, where a relative bound means nothing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.models import build_for_regime as jax_build
from video_filler_tpu.ops import image as jimage
from video_filler_tpu.ops import losses as jlosses
from video_filler_tpu.ops import masks as jmasks
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.checkpoint import convert
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.models import build_for_regime, specs_for_regime
from video_filler_tpu_torch.ops import image as timage
from video_filler_tpu_torch.ops import layers as tlayers
from video_filler_tpu_torch.ops import losses as tlosses
from video_filler_tpu_torch.ops import masks as tmasks
from video_filler_tpu_torch.train import step as tstep

torch.set_num_threads(1)

SMALL = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=2, predLen=2,
             computeDtype="float32")
NET_TOL = dict(rtol=1e-5, atol=1e-5)


def _images(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32) * 2 - 1


def _block_mask(b=2, h=128, w=128, c=1):
    m = np.zeros((b, h, w, c), np.float32)
    m[:, 40:80, 30:90] = 1.0
    m[1:, :, :] = 0.0                     # the second sample: an empty mask
    return m


def _jax_block_draws(key, batch, h, w, max_blocks=10, min_blocks=2):
    """The draws jax's random_block_mask makes (ops/masks.py:106-110)."""
    bs = h // 6
    k_n, k_y, k_x = jax.random.split(key, 3)
    return {
        "n_blocks": jax.random.randint(k_n, (batch,), min_blocks,
                                       max_blocks + 1),
        "tly": jax.random.randint(k_y, (batch, max_blocks), 2, h - bs - 2),
        "tlx": jax.random.randint(k_x, (batch, max_blocks), 2, w - bs - 2),
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# --- ops ------------------------------------------------------------------

def test_masked_fill_fill_in_and_logo_mask_exact():
    x = _images((2, 16, 12, 6), 0)
    src = _images((2, 16, 12, 6), 1)
    m = _block_mask(2, 16, 12)[..., :1]
    m[:, 2:5, 3:7] = 1.0
    xt, mt, st = map(torch.from_numpy, (x, m, src))
    xj, mj, sj = map(jnp.asarray, (x, m, src))
    np.testing.assert_array_equal(
        tmasks.masked_fill(xt, mt, 0.3).numpy(),
        np.asarray(jmasks.masked_fill(xj, mj, 0.3)))
    np.testing.assert_array_equal(tmasks.fill_in(xt, mt, st).numpy(),
                                  np.asarray(jmasks.fill_in(xj, mj, sj)))
    np.testing.assert_array_equal(
        tmasks.apply_logo_mask(xt, mt, 110 / 255).numpy(),
        np.asarray(jmasks.apply_logo_mask(xj, mj, 110 / 255)))
    # unbatched (H,W,1) mask, as make_preprocess.video accepts
    np.testing.assert_array_equal(
        tmasks.apply_logo_mask(xt, mt[0], 110 / 255).numpy(),
        np.asarray(jmasks.apply_logo_mask(xj, mj[0], 110 / 255)))


def test_fill_in_promotes_a_bf16_fake_into_an_f32_target_as_jax_does():
    target = _images((2, 8, 8, 6), 2)
    fake = _images((2, 8, 8, 6), 3)
    m = _block_mask(2, 8, 8)
    m[:, 1:4, 2:6] = 1.0
    ours = tmasks.fill_in(torch.from_numpy(target), torch.from_numpy(m),
                          torch.from_numpy(fake).bfloat16())
    ref = jmasks.fill_in(jnp.asarray(target), jnp.asarray(m),
                         jnp.asarray(fake).astype(jnp.bfloat16))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["byte", "gt03"])
def test_binarize_mask_exact(mode):
    m01 = np.random.RandomState(4).randint(0, 256, (9, 7, 1)) / 255.0
    m01[0, 0] = 1.0
    np.testing.assert_array_equal(tmasks.binarize_mask(m01, mode),
                                  jmasks.binarize_mask(m01, mode))


@pytest.mark.parametrize("hw", [(128, 128), (64, 96)])
def test_random_block_mask_with_jax_draws_exact(hw):
    h, w = hw
    key = jax.random.PRNGKey(5)
    draws = _jax_block_draws(key, 4, h, w)
    ref = jmasks.random_block_mask(key, 4, h, w)
    d = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    ours = tmasks.random_block_mask(d["n_blocks"], d["tly"], d["tlx"], h, w)
    assert ours.shape == (4, h, w, 1) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert 0 < float(ours.mean()) < 1


def test_mask_or_random_block_with_jax_draws_exact():
    key = jax.random.PRNGKey(6)
    cropped = _block_mask(2, 128, 128)
    ref = jmasks.mask_or_random_block(key, jnp.asarray(cropped))
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in _jax_block_draws(key, 2, 128, 128).items()}
    ours = tmasks.mask_or_random_block(torch.from_numpy(cropped), draws)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours[0].numpy(), cropped[0])  # kept
    assert float(ours[1].sum()) > 0                             # fell back


def test_random_block_draws_stay_in_the_lua_range():
    d = tmasks.random_block_draws(torch.Generator().manual_seed(7), 500, 128,
                                  96)
    bs = 128 // 6
    assert int(d["n_blocks"].min()) == 2 and int(d["n_blocks"].max()) == 10
    assert int(d["tly"].min()) == 2 and int(d["tly"].max()) == 128 - bs - 3
    assert int(d["tlx"].min()) == 2 and int(d["tlx"].max()) == 96 - bs - 3


def test_mask_l2_weights_masked_mse_and_gdl_match():
    m = _block_mask(2, 32, 32)
    p, t = _images((2, 32, 32, 6), 8), _images((2, 32, 32, 6), 9)
    for lam in (0.05, 0.0, 1.0):
        np.testing.assert_allclose(
            tlosses.mask_l2_weights(torch.from_numpy(m), lam).numpy(),
            np.asarray(jlosses.mask_l2_weights(jnp.asarray(m), lam)),
            rtol=1e-5)
    pt, tt, mt = map(torch.from_numpy, (p, t, m))
    pj, tj, mj = map(jnp.asarray, (p, t, m))
    np.testing.assert_allclose(
        tlosses.masked_mse(pt, tt, mt, 0.2).item(),
        float(jlosses.masked_mse(pj, tj, mj, 0.2)), rtol=1e-5)
    np.testing.assert_allclose(tlosses.gdl(pt, tt).item(),
                               float(jlosses.gdl(pj, tj)), rtol=1e-5)
    # gdl in f32 from bf16 pred, and along the spatial axes of a clip
    np.testing.assert_allclose(
        tlosses.gdl(pt.bfloat16(), tt).item(),
        float(jlosses.gdl(pj.astype(jnp.bfloat16), tj)), rtol=1e-5)
    p5, t5 = _images((2, 3, 16, 16, 3), 10), _images((2, 3, 16, 16, 3), 11)
    np.testing.assert_allclose(
        tlosses.gdl(torch.from_numpy(p5), torch.from_numpy(t5)).item(),
        float(jlosses.gdl(jnp.asarray(p5), jnp.asarray(t5))), rtol=1e-5)


def test_random_hflip_flips_companions_with_the_same_decisions():
    x, m = _images((4, 8, 6, 6), 12), _block_mask(4, 8, 6)
    m[:, :, :2] = 1.0
    key = jax.random.PRNGKey(3)
    flip = np.asarray(jax.random.uniform(key, (4,)) < 0.5)
    assert 0 < flip.sum() < 4
    rx, rm = jimage.random_hflip(key, jnp.asarray(x), 0.5, jnp.asarray(m))
    ox, om = timage.random_hflip(torch.from_numpy(x), torch.from_numpy(flip),
                                 torch.from_numpy(m))
    np.testing.assert_array_equal(ox.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(om.numpy(), np.asarray(rm))


# --- models ---------------------------------------------------------------

def _nets(regime, seed):
    gen, disc = jax_build(JaxOpt(**SMALL), regime)
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    jg, jd = gen.init(kg), disc.init(kd)
    g, d = build_for_regime(Opt(device="cpu", **SMALL), regime)
    sd_g, sd_d = convert.from_jax(jg[0], jg[1], jd[0], jd[1])
    g.load_state_dict(sd_g, strict=True)
    d.load_state_dict(sd_d, strict=True)
    return gen, disc, jg, jd, g, d


REGIMES = ["video", "logo", "wholeim"]


@pytest.mark.parametrize("regime", REGIMES)
def test_regime_specs_and_state_dict_keys(regime):
    gspec, dspec = specs_for_regime(Opt(device="cpu", **SMALL), regime)
    _, _, (jp, js), (dp, ds), g, d = _nets(regime, 0)
    assert gspec.out_size == 128 and dspec.in_size == 128
    # the JAX trees map onto the port's modules with no special case
    assert set(convert.from_jax(jp, js, dp, ds)[0]) == set(g.state_dict())
    assert set(convert.from_jax(jp, js, dp, ds)[1]) == set(d.state_dict())
    back = convert.to_jax(g.state_dict(), d.state_dict())
    for ours, ref in zip(back, (jp, js, dp, ds)):
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, np.asarray(b))
    mid = {"video": 8, "logo": 4, "wholeim": 8}[regime]
    assert g.dec.up4.weight.shape == (8, mid, 4, 4)
    assert d.conv0.weight.shape == (4, dspec.nc_in, 4, 4)   # ndf/2, no BN
    assert d.conv1.weight.shape == (8, 4, 4, 4)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("regime", REGIMES)
def test_128_generator_and_discriminator_match_jax(regime, train):
    gen, disc, jg, jd, g, d = _nets(regime, 1)
    gspec, dspec = specs_for_regime(Opt(device="cpu", **SMALL), regime)
    x = _images((2, 128, 128, gspec.nc_in), 13)
    ref, ref_state = gen.apply(jg[0], jg[1], jnp.asarray(x), train=train)
    ours = g.train(train)(torch.from_numpy(x))
    assert ours.shape == (2, 128, 128, gspec.nc_out)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **NET_TOL)
    y = _images((2, 128, 128, dspec.nc_in), 14)
    ref_d, ref_dstate = disc.apply(jd[0], jd[1], jnp.asarray(y), train=train)
    ours_d = d.train(train)(torch.from_numpy(y))
    assert ours_d.shape == (2,)
    np.testing.assert_allclose(ours_d.detach().numpy(), np.asarray(ref_d),
                               **NET_TOL)
    for module, ref_s in ((g, ref_state), (d, ref_dstate)):
        _, state = convert.state_dict_to_tree(module.state_dict())
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(ref_s)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_128_discriminator_head_init_is_the_reference_init():
    opt = Opt(device="cpu", **dict(SMALL, ndf=64, predLen=4))
    _, d = build_for_regime(opt, "video", torch.Generator().manual_seed(4))
    for conv in (d.conv0, d.conv1):
        w = conv.weight.detach()
        assert abs(float(w.std()) - 0.02) < 2e-3
        assert abs(float(w.mean())) < 2e-3
    # the head has no BatchNorm: the first one follows conv2
    assert list(d.keys())[:6] == ["conv0", "lrelu0", "conv1", "lrelu1",
                                  "conv2", "bn2"]
    assert isinstance(d.bn2, tlayers.BatchNorm)


# --- preprocess -----------------------------------------------------------

def _jax_video_draws(key, b, h, w, fs):
    """The decisions jax's make_preprocess.video makes from ``key``."""
    k_crop, k_blk, k_flip = jax.random.split(key, 3)
    ky, kx = jax.random.split(k_crop)
    draws = {
        "y0": jax.random.randint(ky, (b,), 0, max(h - fs, 1)),
        "x0": jax.random.randint(kx, (b,), 0, max(w - fs, 1)),
        "flip": jax.random.uniform(k_flip, (b,)) < 0.5,
        "blocks": _jax_block_draws(k_blk, b, fs, fs),
    }
    return _to_torch(draws)


@pytest.mark.parametrize("donkey_file", ["", "donkey_folder_norandblk.lua"],
                         ids=["randblk", "norandblk"])
@pytest.mark.parametrize("batched_mask", [True, False],
                         ids=["mask_BHW1", "mask_HW1"])
def test_video_preprocess_matches_jax_with_its_decisions(donkey_file,
                                                         batched_mask):
    kw = dict(SMALL, batchSize=4, donkey_file=donkey_file)
    rs = np.random.RandomState(15)
    raw = rs.randint(0, 256, (4, 150, 160, 6), np.uint8)
    mask = np.zeros((150, 160, 1), np.uint8)
    mask[60:100, 20:140] = 1
    if batched_mask:
        mask = np.repeat(mask[None], 4, axis=0)
        mask[2] = 0                       # an empty crop: random blocks
    key = jax.random.PRNGKey(22)
    ref = jstep.make_preprocess(JaxOpt(**kw), "video")(
        {"raw": jnp.asarray(raw), "mask": jnp.asarray(mask)}, key)
    draws = _jax_video_draws(key, 4, 150, 160, 128)
    assert 0 < int(draws["flip"].sum()) < 4
    ours = tstep.make_preprocess(Opt(device="cpu", **kw), "video")(
        {"raw": torch.from_numpy(raw), "mask": torch.from_numpy(mask)},
        draws=draws)
    for k in ("real", "mask"):
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_logo_and_wholeim_preprocess_match_jax():
    rs = np.random.RandomState(16)
    key = jax.random.PRNGKey(23)
    pair = {"raw_masked": rs.randint(0, 256, (4, 128, 128, 3), np.uint8),
            "raw_gt": rs.randint(0, 256, (4, 128, 128, 3), np.uint8)}
    ref = jstep.make_preprocess(JaxOpt(**SMALL), "logo")(
        {k: jnp.asarray(v) for k, v in pair.items()}, key)
    flip = torch.from_numpy(np.array(jax.random.uniform(key, (4,)) < 0.5))
    ours = tstep.make_preprocess(Opt(device="cpu", **SMALL), "logo")(
        {k: torch.from_numpy(v) for k, v in pair.items()},
        draws={"flip": flip})
    for k in ("masked", "real"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    patches = {"raw_masked": rs.randint(0, 256, (2, 128, 128, 27), np.uint8),
               "raw_real": rs.randint(0, 256, (2, 128, 128, 12), np.uint8),
               "mask": rs.randint(0, 2, (2, 128, 128, 12)).astype(np.uint8)}
    ref = jstep.make_preprocess(JaxOpt(**SMALL), "wholeim")(
        {k: jnp.asarray(v) for k, v in patches.items()}, key)
    ours = tstep.make_preprocess(Opt(device="cpu", **SMALL), "wholeim")(
        {k: torch.from_numpy(v) for k, v in patches.items()},
        torch.Generator().manual_seed(0))
    for k in ("masked", "real", "mask"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("regime,shape", [
    ("center", (3, 140, 150, 3)), ("video", (3, 140, 150, 6)),
    ("logo", (3, 128, 128, 3)), ("wholeim", (3, 128, 128, 27))])
def test_draws_are_seeded(regime, shape):
    fn = getattr(tstep, f"{regime}_draws")
    opt = Opt(device="cpu", **SMALL)
    a = fn(opt, torch.Generator().manual_seed(9), shape)
    b = fn(opt, torch.Generator().manual_seed(9), shape)
    flat_a = jax.tree.leaves({k: v for k, v in a.items()})
    flat_b = jax.tree.leaves({k: v for k, v in b.items()})
    assert len(flat_a) == len(flat_b)
    assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
