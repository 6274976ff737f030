"""The port's fused weighted MSE (plain path on the CPU) against the JAX
package: its Pallas kernel in interpret mode on shapes the Pallas gate
accepts, and ``losses.weighted_mse`` on the center shape the gate rejects.

Tolerances: forward rtol 1e-5; gradients rtol 1e-5 / atol 1e-7 (the JAX
suite's own, tests/test_pallas.py); bf16 gradients one bf16 rounding apart
(rtol 2**-7) because the two frameworks multiply the factors in another
order before rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.ops import losses as jlosses
from video_filler_tpu.ops.pallas import fused_weighted_mse as jax_fused
from video_filler_tpu.ops.pallas import pallas_supported
from video_filler_tpu_torch.ops import losses as tlosses
from video_filler_tpu_torch.ops import masks as tmasks
from video_filler_tpu_torch.ops.cuda import fused_loss as fl

torch.set_num_threads(1)


def _data(shape, wshape, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32),
            rs.rand(*wshape).astype(np.float32))


def _ring():
    return np.array(jlosses.overlap_l2_weights((64, 64), 4, 0.999)[None])


# (name, pred shape, weights shape or None for the center ring, JAX path)
CASES = [
    ("full_weights", (2, 16, 16, 8), (2, 16, 16, 8), "pallas"),
    ("mask_weights", (2, 8, 16, 8), (2, 8, 16, 1), "pallas"),
    ("center_ring", (2, 64, 64, 3), None, "jnp"),
]


def _case(name, shape, wshape, seed):
    p, t, w = _data(shape, wshape or (1, 1, 1, 1), seed)
    if wshape is None:
        w = _ring()
    return p, t, w


def _jax_loss(path):
    if path == "pallas":
        return lambda p, t, w: jax_fused(p, t, w, True)
    return jlosses.weighted_mse


@pytest.mark.parametrize("name,shape,wshape,path", CASES,
                         ids=[c[0] for c in CASES])
def test_forward_matches_jax(name, shape, wshape, path):
    p, t, w = _case(name, shape, wshape, 0)
    assert pallas_supported(shape) == (path == "pallas")
    ref = float(_jax_loss(path)(jnp.asarray(p), jnp.asarray(t),
                                jnp.asarray(w)))
    ours = fl.fused_weighted_mse(torch.from_numpy(p), torch.from_numpy(t),
                                 torch.from_numpy(w))
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(float(ours), ref, rtol=1e-5)


@pytest.mark.parametrize("name,shape,wshape,path", CASES,
                         ids=[c[0] for c in CASES])
def test_gradient_matches_jax(name, shape, wshape, path):
    p, t, w = _case(name, shape, wshape, 1)
    tj, wj = jnp.asarray(t), jnp.asarray(w)
    f = _jax_loss(path)
    g_ref = jax.grad(lambda x: 1.7 * f(x, tj, wj))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    (1.7 * fl.fused_weighted_mse(pt, torch.from_numpy(t),
                                 torch.from_numpy(w))).backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-7)


def test_center_target_view_and_port_ring_weights():
    """The step's operands: the target is a strided center view of the real
    batch, the weights the port's own (1,64,64,1) ring."""
    rs = np.random.RandomState(2)
    real = rs.rand(2, 128, 128, 3).astype(np.float32) * 2 - 1
    pred = rs.randn(2, 64, 64, 3).astype(np.float32)
    target = tmasks.extract_center(torch.from_numpy(real))
    assert not target.is_contiguous()
    ring = tlosses.overlap_l2_weights((64, 64), 4, 0.999)[None]
    np.testing.assert_array_equal(ring.numpy(), _ring())
    pt = torch.from_numpy(pred).requires_grad_(True)
    loss = fl.fused_weighted_mse(pt, target, ring)
    loss.backward()
    center_j = jnp.asarray(real)[:, 32:96, 32:96, :]
    val, g = jax.value_and_grad(jlosses.weighted_mse)(
        jnp.asarray(pred), center_j, jnp.asarray(_ring()))
    np.testing.assert_allclose(loss.item(), float(val), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(g), rtol=1e-5,
                               atol=1e-7)


def test_bf16_pred_matches_jax():
    p, t, w = _data((2, 64, 64, 3), (1, 64, 64, 1), 3)
    pj = jnp.asarray(p).astype(jnp.bfloat16)
    val, g = jax.value_and_grad(jlosses.weighted_mse)(
        pj, jnp.asarray(t), jnp.asarray(w))
    pt = torch.from_numpy(np.asarray(pj.astype(jnp.float32))).bfloat16()
    pt.requires_grad_(True)
    loss = fl.fused_weighted_mse(pt, torch.from_numpy(t), torch.from_numpy(w))
    loss.backward()
    assert pt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.item(), float(val), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.float().numpy(),
                               np.asarray(g.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)


def test_plain_grad_reference_is_the_analytic_gradient():
    p, t, w = _data((3, 7, 9, 5), (3, 7, 9, 1), 4)
    pt = torch.from_numpy(p).requires_grad_(True)
    tt, wt = torch.from_numpy(t), torch.from_numpy(w)
    gbar = torch.tensor(0.3)
    (fl.weighted_mse_reference(pt, tt, wt) * gbar).backward()
    np.testing.assert_allclose(
        fl.weighted_mse_grad_reference(pt.detach(), tt, wt, gbar).numpy(),
        pt.grad.numpy(), rtol=1e-6, atol=1e-9)


def test_cpu_tensors_take_the_plain_path_without_launching():
    before = dict(fl.LAUNCHES)
    p, t, w = _data((2, 8, 8, 3), (1, 8, 8, 1), 5)
    pt = torch.from_numpy(p).requires_grad_(True)
    fl.fused_weighted_mse(pt, torch.from_numpy(t),
                          torch.from_numpy(w)).backward()
    assert fl.LAUNCHES == before


@pytest.mark.parametrize("bad", ["3d_pred", "int_pred", "f64_target",
                                 "shape_mismatch", "weights_no_broadcast",
                                 "empty", "meta_device"])
def test_rejects_what_the_kernel_does_not_take(bad):
    p = torch.zeros(2, 4, 4, 3)
    t = torch.zeros(2, 4, 4, 3)
    w = torch.ones(1, 4, 4, 1)
    if bad == "3d_pred":
        p, t = p[0], t[0]
    elif bad == "int_pred":
        p = p.int()
    elif bad == "f64_target":
        t = t.double()
    elif bad == "shape_mismatch":
        t = torch.zeros(2, 4, 4, 2)
    elif bad == "weights_no_broadcast":
        w = torch.ones(1, 4, 3, 1)
    elif bad == "empty":
        p, t = torch.zeros(0, 4, 4, 3), torch.zeros(0, 4, 4, 3)
    elif bad == "meta_device":
        p, t, w = (x.to("meta") for x in (p, t, w))
    with pytest.raises((ValueError, TypeError)):
        fl.fused_weighted_mse(p, t, w)
