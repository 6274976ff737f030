"""Port ops against the JAX package's, on the same numpy inputs.

Tolerances: elementwise image/mask ops exact; losses rtol 1e-6; convs and
BatchNorm rtol 1e-4 / atol 1e-5 (summation order differs between XLA-CPU
and PyTorch's CPU kernels); random crop/flip exact with the JAX side's
decisions passed in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.ops import image as jimage
from video_filler_tpu.ops import layers as jlayers
from video_filler_tpu.ops import losses as jlosses
from video_filler_tpu.ops import masks as jmasks
from video_filler_tpu_torch.ops import image as timage
from video_filler_tpu_torch.ops import layers as tlayers
from video_filler_tpu_torch.ops import losses as tlosses
from video_filler_tpu_torch.ops import masks as tmasks

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _images(shape=(2, 128, 128, 3), seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32) * 2 - 1


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_normalize_and_denormalize_exact():
    raw = np.random.RandomState(1).randint(0, 256, (2, 9, 7, 3), np.uint8)
    ours = timage.normalize_uint8(torch.from_numpy(raw))
    ref = np.asarray(jimage.normalize_uint8(jnp.asarray(raw)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    x = _images((2, 9, 7, 3), 2) * 1.2
    np.testing.assert_array_equal(
        timage.denormalize_to_uint8(torch.from_numpy(x)).numpy(),
        np.asarray(jimage.denormalize_to_uint8(jnp.asarray(x))))


@pytest.mark.parametrize("overlap", [0, 4])
def test_center_masks_exact(overlap):
    x = _images()
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    assert tmasks.center_region(128) == jmasks.center_region(128)
    np.testing.assert_array_equal(tmasks.extract_center(xt).numpy(),
                                  np.asarray(jmasks.extract_center(xj)))
    np.testing.assert_array_equal(
        tmasks.center_mask_fill(xt, overlap).numpy(),
        np.asarray(jmasks.center_mask_fill(xj, overlap)))
    pred = _images((2, 64, 64, 3), 3)
    np.testing.assert_array_equal(
        tmasks.paste_center(xt, torch.from_numpy(pred), overlap).numpy(),
        np.asarray(jmasks.paste_center(xj, jnp.asarray(pred), overlap)))
    assert tmasks.CENTER_FILL_RGB == jmasks.CENTER_FILL_RGB


def test_center_mask_fill_repeats_per_frame():
    x = _images((1, 32, 32, 6), 4)
    np.testing.assert_array_equal(
        tmasks.center_mask_fill(torch.from_numpy(x), 2).numpy(),
        np.asarray(jmasks.center_mask_fill(jnp.asarray(x), 2)))


@pytest.mark.parametrize("overlap", [0, 4])
def test_overlap_l2_weights_exact(overlap):
    np.testing.assert_array_equal(
        tlosses.overlap_l2_weights((64, 64), overlap, 0.999).numpy(),
        np.asarray(jlosses.overlap_l2_weights((64, 64), overlap, 0.999)))


def test_losses_match():
    rs = np.random.RandomState(5)
    logits = rs.randn(16).astype(np.float32) * 4
    for label in (0.0, 1.0):
        np.testing.assert_allclose(
            tlosses.bce_with_logits(torch.from_numpy(logits), label).item(),
            float(jlosses.bce_with_logits(jnp.asarray(logits), label)),
            rtol=1e-6)
    p, t = _images((2, 8, 8, 3), 6), _images((2, 8, 8, 3), 7)
    np.testing.assert_allclose(
        tlosses.mse(torch.from_numpy(p), torch.from_numpy(t)).item(),
        float(jlosses.mse(jnp.asarray(p), jnp.asarray(t))), rtol=1e-6)
    w = rs.rand(1, 8, 8, 1).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.weighted_mse(torch.from_numpy(p), torch.from_numpy(t),
                             torch.from_numpy(w)).item(),
        float(jlosses.weighted_mse(jnp.asarray(p), jnp.asarray(t),
                                   jnp.asarray(w))), rtol=1e-6)


# (cin, cout, kernel, stride, padding, input spatial size)
CONVS = [(3, 8, 4, 2, 1, 32), (16, 32, 4, 1, 0, 4)]


@pytest.mark.parametrize("cin,cout,k,s,p,hw", CONVS,
                         ids=["stride2", "valid4x4"])
def test_conv2d_matches_jax(cin, cout, k, s, p, hw):
    layer = jlayers.conv2d(cin, cout, k, s, p, False, jnp.float32)
    params, _ = layer.init(jax.random.PRNGKey(0))
    x = _images((2, hw, hw, cin), 8)
    ref, _ = layer.apply(params, {}, jnp.asarray(x))
    w = torch.from_numpy(np.asarray(params["w"]).transpose(3, 2, 0, 1).copy())
    ours = tlayers.conv2d(_nchw(x), w, s, p, torch.float32)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), **TOL)


# (cin, cout, kernel, stride, padding, input size, JAX sub-pixel path)
CONVTS = [(16, 32, 4, 1, 0, 1, True), (8, 4, 4, 2, 1, 8, True),
          (8, 4, 4, 2, 1, 8, False)]


@pytest.mark.parametrize("cin,cout,k,s,p,hw,subpixel", CONVTS,
                         ids=["head1x1", "ladder_subpixel", "ladder_dilated"])
def test_conv2d_transpose_matches_jax(cin, cout, k, s, p, hw, subpixel):
    layer = jlayers.conv2d_transpose(cin, cout, k, s, p, False, jnp.float32,
                                     subpixel=subpixel)
    params, _ = layer.init(jax.random.PRNGKey(1))
    x = _images((2, hw, hw, cin), 9)
    ref, _ = layer.apply(params, {}, jnp.asarray(x))
    w = torch.from_numpy(np.asarray(params["w"]).transpose(2, 3, 0, 1).copy())
    ours = tlayers.conv2d_transpose(_nchw(x), w, s, p, torch.float32)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), **TOL)


def _bn_pair(ch=6, seed=2):
    layer = jlayers.batch_norm(ch)
    params, state = layer.init(jax.random.PRNGKey(seed))
    state = {"mean": jnp.linspace(-0.5, 0.5, ch),
             "var": jnp.linspace(0.5, 2, ch)}
    bn = tlayers.BatchNorm(ch)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(np.asarray(params["gamma"])))
        bn.bias.copy_(torch.from_numpy(np.asarray(params["beta"]) + 0.1))
        bn.running_mean.copy_(torch.tensor(np.asarray(state["mean"])))
        bn.running_var.copy_(torch.tensor(np.asarray(state["var"])))
    params = dict(params, beta=params["beta"] + 0.1)
    return layer, params, state, bn


def test_batch_norm_train_matches_jax_including_running_stats():
    layer, params, state, bn = _bn_pair()
    x = _images((4, 5, 5, 6), 10) * 3 + 0.5
    ref, new_state = layer.apply(params, state, jnp.asarray(x), train=True)
    ours = bn.train()(_nchw(x))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_state["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_state["var"]), **TOL)


def test_batch_norm_eval_matches_jax():
    layer, params, state, bn = _bn_pair(seed=3)
    x = _images((4, 5, 5, 6), 11)
    ref, _ = layer.apply(params, state, jnp.asarray(x), train=False)
    np.testing.assert_allclose(_nhwc(bn.eval()(_nchw(x))), np.asarray(ref),
                               **TOL)


def test_batch_norm_without_stat_update_uses_batch_stats():
    _, _, _, bn = _bn_pair(seed=4)
    x = _nchw(_images((4, 5, 5, 6), 12))
    before = (bn.running_mean.clone(), bn.running_var.clone())
    y_frozen = bn.train()(x, update_stats=False)
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])
    torch.testing.assert_close(y_frozen, bn(x), rtol=0, atol=0)
    assert not torch.equal(bn.running_mean, before[0])


def test_batch_norm_bf16_output_dtype_and_f32_stats():
    _, _, _, bn = _bn_pair(seed=5)
    x = _nchw(_images((4, 5, 5, 6), 13)).bfloat16()
    y = bn.train()(x)
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == torch.float32


def test_random_hflip_with_jax_decisions():
    x = _images((4, 8, 6, 3), 14)
    key = jax.random.PRNGKey(3)
    flip = np.asarray(jax.random.uniform(key, (4,)) < 0.5)
    assert 0 < flip.sum() < 4
    ref = jimage.random_hflip(key, jnp.asarray(x))
    np.testing.assert_array_equal(
        timage.random_hflip(torch.from_numpy(x),
                            torch.from_numpy(flip)).numpy(),
        np.asarray(ref))


def test_random_crop_with_jax_decisions():
    raw = np.random.RandomState(16).randint(0, 256, (3, 40, 50, 3), np.uint8)
    key = jax.random.PRNGKey(4)
    ky, kx = jax.random.split(key)
    y0 = np.asarray(jax.random.randint(ky, (3,), 0, 40 - 32))
    x0 = np.asarray(jax.random.randint(kx, (3,), 0, 50 - 32))
    ref = jimage.random_crop(key, jnp.asarray(raw), 32)
    ours = timage.random_crop(torch.from_numpy(raw), 32,
                              torch.from_numpy(y0), torch.from_numpy(x0))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_draws_are_seeded_and_in_the_lua_range():
    a = timage.draw_crop_offsets(torch.Generator().manual_seed(7), 64, 40, 50,
                                 32)
    b = timage.draw_crop_offsets(torch.Generator().manual_seed(7), 64, 40, 50,
                                 32)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert 0 <= int(a[0].min()) and int(a[0].max()) < 40 - 32
    assert 0 <= int(a[1].min()) and int(a[1].max()) < 50 - 32
    flips = timage.draw_flips(torch.Generator().manual_seed(8), 1000)
    assert flips.dtype == torch.bool and 400 < int(flips.sum()) < 600
