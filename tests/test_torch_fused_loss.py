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


# --- the kernels' plan and byte count (pure Python, reached on the CPU) ---

MAIN_PATH = [
    # (name, regime, options, batch channels {key: C})
    ("center", "center", dict(overlapPred=4), {"real": 3}),
    ("video", "video", dict(predLen=4, weight_nomask=0.05),
     {"real": 12, "mask": 1}),
    ("video_composite", "video", dict(predLen=4, weight_nomask=0.0),
     {"real": 12, "mask": 1}),
    ("wholeim", "wholeim", dict(weight_nomask=0.05),
     {"real": 12, "mask": 12, "masked": 27}),
    ("logo", "logo", {}, {"real": 3, "masked": 3}),
]


def _step_operands(regime, extra, channels, dtype="bfloat16"):
    """(pred, target, weights) as one CPU train step at fineSize 128 hands
    them to the loss (narrow widths; the operands' geometry is the full
    one's but for the batch)."""
    from video_filler_tpu_torch.config import Opt
    from video_filler_tpu_torch.train import step as tstep
    opt = Opt(device="cpu", nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=2,
              wtl2=0.999, computeDtype=dtype, **extra)
    rs = np.random.RandomState(7)
    batch = {}
    for key, c in channels.items():
        if key == "mask":
            m = np.zeros((2, 128, 128, c), np.float32)
            m[:, 40:80, 30:90] = 1.0
            batch[key] = torch.from_numpy(m)
        else:
            batch[key] = torch.from_numpy(
                rs.uniform(-1, 1, (2, 128, 128, c)).astype(np.float32))
    seen = []

    def spy(pred, target, weights):
        seen.append((pred.detach(), target, weights))
        return fl.fused_weighted_mse(pred, target, weights)

    state = tstep.init_train_state(opt, regime,
                                   torch.Generator().manual_seed(0))
    orig = tstep.fused_weighted_mse
    tstep.fused_weighted_mse = spy
    try:
        tstep.make_train_step(opt, regime)(state, batch)
    finally:
        tstep.fused_weighted_mse = orig
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("name,regime,extra,channels", MAIN_PATH,
                         ids=[m[0] for m in MAIN_PATH])
def test_main_path_operands_plan_to_the_32bit_row_path(name, regime, extra,
                                                       channels):
    pred, target, w = _step_operands(regime, extra, channels)
    p = fl.plan(pred, target, w)
    assert (p.variant, p.index32, p.reason) == ("row", True, "")
    assert pred.is_contiguous()   # G's output, through the channels-last
    assert p.vec == 16 // pred.element_size()  # decoder
    if name == "center":
        assert p.target_strides[:2] == (128 * 128 * 3, 384)   # the crop
        assert p.weight_strides == (0, 64, 1, 0)               # the ring
    if name == "video_composite":
        assert pred.dtype == torch.float32 and p.vec == 4
    assert p.weights_vec == (name == "wholeim")   # full-size weights
    if name == "logo":
        assert p.weight_strides == (0, 0, 0, 0)


def _ragged_operands():
    rs = np.random.RandomState(8)
    p = torch.from_numpy(rs.randn(3, 5, 7, 9).astype(np.float32))
    return {
        "permuted_pred": (p.permute(0, 2, 3, 1),
                          torch.from_numpy(rs.randn(3, 7, 9, 5)
                                           .astype(np.float32)),
                          torch.from_numpy(rs.rand(3, 7, 9, 1)
                                           .astype(np.float32))),
        "ragged_row": (p.permute(0, 2, 3, 1).contiguous(),
                       torch.from_numpy(rs.randn(3, 7, 9, 5)
                                        .astype(np.float32)),
                       torch.from_numpy(rs.rand(3, 7, 9, 1)
                                        .astype(np.float32))),
        "misaligned_target": (torch.zeros(2, 4, 4, 8),
                              torch.zeros(2 * 4 * 4 * 8 + 1)[1:]
                              .view(2, 4, 4, 8),
                              torch.ones(())),
        "permuted_target": (torch.zeros(2, 4, 4, 8),
                            torch.zeros(2, 8, 4, 4).permute(0, 2, 3, 1),
                            torch.ones(1, 4, 4, 1)),
    }


@pytest.mark.parametrize("name", list(_ragged_operands()))
def test_other_geometries_plan_to_the_generic_path(name):
    pred, target, w = _ragged_operands()[name]
    p = fl.plan(pred, target, w)
    assert p.variant == "generic" and p.index32 and p.reason
    assert not p.weights_vec


def _flat(t):
    """The tensor's whole storage as a 1-D tensor of its dtype."""
    return torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())


def _fdiv(n, d):
    m, s = fl.fast_div(d)
    return (((n * m) >> 32) + n) >> s


def _walk_row_plan(p, pred, target, weights):
    """Gather the operands the way the row kernels address them, from the
    plan's meta alone: tile t -> row r, column j0 -> (b, y); element
    j0 + e -> (x, c) for the weights.  Returns (pred, target, weights) in
    (B,H,W,C) order and each tile's gradient offset."""
    meta = p.meta
    b_, h, w_, c = meta[0:4]
    vec = p.vec
    vecs = w_ * c // vec
    assert meta[19:21] == fl.fast_div(vecs)
    t = np.arange(b_ * h * vecs, dtype=np.int64)
    r = _fdiv(t, vecs)
    j0 = (t - r * vecs) * vec
    b = _fdiv(r, h)
    y = r - b * h
    j = j0[:, None] + np.arange(vec)[None, :]
    x = _fdiv(j, c)
    cc = j - x * c

    def gather(tensor, offsets):
        base = tensor.storage_offset()
        return _flat(tensor)[torch.from_numpy(base + offsets)]

    ps, ts, ws = meta[4:8], meta[8:12], meta[12:16]
    got_p = gather(pred, (b * ps[0] + y * ps[1])[:, None] + j)
    got_t = gather(target, (b * ts[0] + y * ts[1])[:, None] + j)
    got_w = gather(weights, (b * ws[0] + y * ws[1])[:, None]
                   + x * ws[2] + cc * ws[3])
    shape = (b_, h, w_, c)
    return (got_p.reshape(shape), got_t.reshape(shape), got_w.reshape(shape),
            r * (w_ * c) + j0, t * vec)


@pytest.mark.parametrize("name,regime,extra,channels", MAIN_PATH,
                         ids=[m[0] for m in MAIN_PATH])
def test_row_plan_walk_reproduces_the_operands(name, regime, extra, channels):
    pred, target, w = _step_operands(regime, extra, channels)
    p = fl.plan(pred, target, w)
    got_p, got_t, got_w, linear, grad_at = _walk_row_plan(p, pred, target, w)
    torch.testing.assert_close(got_p, pred, rtol=0, atol=0)
    torch.testing.assert_close(got_t, target, rtol=0, atol=0)
    torch.testing.assert_close(got_w, w.expand(pred.shape), rtol=0, atol=0)
    np.testing.assert_array_equal(linear, grad_at)   # 16-B gradient stores


@pytest.mark.parametrize("name", list(_ragged_operands()))
def test_generic_plan_strides_reproduce_the_operands(name):
    pred, target, w = _ragged_operands()[name]
    p = fl.plan(pred, target, w)
    shape = p.shape
    for t, strides in ((pred, p.pred_strides), (target, p.target_strides),
                       (w, p.weight_strides)):
        walked = torch.as_strided(_flat(t), shape, strides,
                                  t.storage_offset())
        torch.testing.assert_close(walked, t.expand(shape), rtol=0, atol=0)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 12, 24, 27, 64, 96, 128,
                               192, 384, 1536, 4096, 100003, 2 ** 30 + 1])
def test_fast_division_is_exact_below_2_31(d):
    rs = np.random.RandomState(d % 1000)
    k = np.unique(np.linspace(1, (2 ** 31 - 2) // d, 2000).astype(np.int64))
    n = np.concatenate([np.arange(0, min(4 * d + 5, 20000)),
                        k * d - 1, k * d, k * d + 1, [2 ** 31 - 1],
                        rs.randint(0, 2 ** 31, 20000)]).astype(np.int64)
    m, s = fl.fast_div(d)
    assert 0 < m < 2 ** 32
    assert (((n * m) >> 32) + n).max() < 2 ** 32   # the 32-bit sum
    np.testing.assert_array_equal(_fdiv(n, d), n // d)


def _meta_tensor(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


BYTES = [
    # (name, pred, target, weights, fwd bytes, bwd bytes)
    ("video", (64, 128, 128, 12), torch.bfloat16, None, (64, 128, 128, 1),
     79_691_776, 104_857_600),
    ("video_composite", (64, 128, 128, 12), torch.float32, None,
     (64, 128, 128, 1), 104_857_600, 155_189_248),
    ("wholeim", (64, 128, 128, 12), torch.bfloat16, None, (64, 128, 128, 12),
     125_829_120, 150_994_944),
    ("logo", (64, 128, 128, 3), torch.bfloat16, None, (), 18_874_372,
     25_165_828),
    ("center", (64, 64, 64, 3), torch.bfloat16, "crop", (1, 64, 64, 1),
     4_734_976, 6_307_840),
]


@pytest.mark.parametrize("name,shape,dtype,crop,wshape,fwd,bwd", BYTES,
                         ids=[b[0] for b in BYTES])
def test_kernel_bytes(name, shape, dtype, crop, wshape, fwd, bwd):
    pred = _meta_tensor(shape, dtype)
    if crop:   # the center crop of the (B,128,128,3) real batch
        target = _meta_tensor((64, 128, 128, 3))[:, 32:96, 32:96, :]
    else:
        target = _meta_tensor(shape)
    weights = _meta_tensor(wshape)
    assert fl.kernel_bytes(pred, target, weights, "fwd") == fwd
    assert fl.kernel_bytes(pred, target, weights, "bwd") == bwd
    # a broadcast view of the weights counts at its stored size
    assert fl.kernel_bytes(pred, target, weights.expand(shape), "fwd") == fwd
