"""The port on the card (marker ``cuda``): its CUDA kernels (against
their plain versions, the path each geometry takes, one launch per forward,
bitwise repeats, the per-stream workspace), the train step and inference
(the generator loader and the server function of every mode) against the
CPU.

Skipped where there is no CUDA device; on a machine with one they build
video_filler_tpu_torch/csrc/ with nvcc.  Run there with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

This file imports no jax (``--noconftest`` skips the suite's jax setup).
Tolerances: forward rtol 1e-5, f32 backward rtol 1e-6, bf16 backward one
bf16 rounding (rtol 2**-7); the kernel and its plain version compute the
same formula, the forward in another summation order.  Card against CPU:
step metrics rtol 1e-3, inference forwards rtol 1e-4 / atol 1e-5, served
uint8 within one level (cuDNN's conv algorithms sum in another order).
"""

import numpy as np
import pytest
import torch

from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.ops import losses, masks
from video_filler_tpu_torch.ops.cuda import fused_loss as fl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, with TF32 off for f32 convs and matmuls (cuDNN's default
    is on, which would hold the card to ~1e-3 against the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        saved


def _operands(dev, shape, dtype, strided_target):
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, w, c = shape
    pred = torch.randn(shape, generator=g, device=dev).to(dtype)
    if strided_target:
        real = torch.randn(b, 2 * h, 2 * w, c, generator=g, device=dev)
        target = masks.extract_center(real)
        weights = losses.overlap_l2_weights((h, w), 4, 0.999, device=dev)[None]
    else:
        target = torch.randn(shape, generator=g, device=dev)
        weights = torch.rand(b, h, w, 1, generator=g, device=dev)
    return pred, target, weights


CASES = [((64, 64, 64, 3), torch.float32, True),
         ((64, 64, 64, 3), torch.bfloat16, True),
         ((3, 7, 9, 5), torch.float32, False),
         ((3, 7, 9, 5), torch.bfloat16, False)]


def _regime_operands(dev, geometry):
    """The loss kernels' operands in the 128x128 regimes (train/step.py):
    video with (B,H,W,1) mask weights, stride 0 on C; its composite, whose
    pred is f32 because a bf16 fake filled into the f32 clip promotes;
    wholeim with full-size weights; logo with a 0-dim weight; video3d's
    (B,T,H,W,C) clips with (B,1,H,W,1) weights, stride 0 on T and C, and
    their composite."""
    g = torch.Generator(device=dev).manual_seed(1)
    b = 16
    if geometry.startswith("video3d"):
        clip = torch.rand(b, 4, 128, 128, 3, generator=g, device=dev) * 2 - 1
        fake = (torch.rand(b, 4, 128, 128, 3, generator=g, device=dev) * 2
                - 1).bfloat16()
        mask = (torch.rand(b, 1, 128, 128, 1, generator=g, device=dev)
                < 0.3).float()
        w = 0.999 * losses.mask_l2_weights(mask, 0.05)
        if geometry == "video3d":
            return fake, clip, w
        return masks.fill_in(clip, mask, fake), clip, w
    clip = torch.rand(b, 128, 128, 12, generator=g, device=dev) * 2 - 1
    fake = (torch.rand(b, 128, 128, 12, generator=g, device=dev) * 2
            - 1).bfloat16()
    mask = (torch.rand(b, 128, 128, 1, generator=g, device=dev) < 0.3).float()
    w_vid = 0.999 * losses.mask_l2_weights(mask, 0.05)
    if geometry == "video":
        return fake, clip, w_vid
    if geometry == "video_composite":
        return masks.fill_in(clip, mask, fake), clip, w_vid
    if geometry == "wholeim":
        mask_full = (torch.rand(b, 128, 128, 12, generator=g, device=dev)
                     < 0.3).float()
        return fake, clip, 0.999 * losses.mask_l2_weights(mask_full, 0.05)
    return (fake[..., :3].contiguous(), clip[..., :3].contiguous(),
            torch.tensor(0.999, device=dev))


REGIME_CASES = ["video", "video_composite", "wholeim", "logo", "video3d",
                "video3d_composite"]


def _check_against_plain(dev, pred, target, w):
    before = dict(fl.LAUNCHES)
    leaf = pred.clone().requires_grad_(True)
    loss = fl.fused_weighted_mse(leaf, target, w)
    loss.backward(torch.tensor(1.3, device=dev))
    torch.cuda.synchronize()
    assert fl.LAUNCHES == {"fwd": before["fwd"] + 1,
                           "bwd": before["bwd"] + 1}
    ref = fl.weighted_mse_reference(pred, target, w)
    torch.testing.assert_close(loss.detach(), ref, rtol=1e-5, atol=0)
    ref_grad = fl.weighted_mse_grad_reference(pred, target, w,
                                              torch.tensor(1.3, device=dev))
    assert leaf.grad.dtype == pred.dtype
    rtol = 1e-6 if pred.dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(leaf.grad.float(), ref_grad.float(),
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("shape,dtype,strided", CASES,
                         ids=["center_f32", "center_bf16", "ragged_f32",
                              "ragged_bf16"])
def test_kernels_match_plain_version(cuda, shape, dtype, strided):
    _check_against_plain(cuda, *_operands(cuda, shape, dtype, strided))


@pytest.mark.parametrize("geometry", REGIME_CASES)
def test_kernels_match_plain_version_on_the_regime_operands(cuda, geometry):
    pred, target, w = _regime_operands(cuda, geometry)
    if geometry.endswith("composite"):
        assert pred.dtype == torch.float32
    p = fl.plan(pred, target, w)
    assert (p.variant, p.index32) == ("row", True)
    _check_against_plain(cuda, pred, target, w)
    assert torch.equal(fl.launch_forward(pred, target, w),
                       fl.launch_forward(pred, target, w))


def test_forward_is_bitwise_repeatable(cuda):
    pred, target, w = _operands(cuda, (64, 64, 64, 3), torch.bfloat16, True)
    a = fl.launch_forward(pred, target, w)
    b = fl.launch_forward(pred, target, w)
    assert torch.equal(a, b)


def _video_operands(dev, b=64):
    """The video step's loss operands at full size: bf16 fake, f32 clip,
    (B,H,W,1) mask weights."""
    g = torch.Generator(device=dev).manual_seed(2)
    clip = torch.rand(b, 128, 128, 12, generator=g, device=dev) * 2 - 1
    fake = (torch.rand(b, 128, 128, 12, generator=g, device=dev) * 2
            - 1).bfloat16()
    mask = (torch.rand(b, 128, 128, 1, generator=g, device=dev) < 0.3).float()
    return fake, clip, 0.999 * losses.mask_l2_weights(mask, 0.05)


@pytest.mark.parametrize("geometry", ["center_f32", "center_bf16",
                                      *REGIME_CASES, "ragged_f32",
                                      "ragged_bf16"])
def test_launches_count_by_variant(cuda, geometry):
    """The main-path geometries take the row path, the ragged ones the
    generic path: one launch of that variant per direction."""
    if geometry in REGIME_CASES:
        pred, target, w = _regime_operands(cuda, geometry)
    else:
        shape, dtype, strided = CASES[["center_f32", "center_bf16",
                                       "ragged_f32", "ragged_bf16"]
                                      .index(geometry)]
        pred, target, w = _operands(cuda, shape, dtype, strided)
    variant = "generic" if geometry.startswith("ragged") else "row"
    assert fl.plan(pred, target, w).variant == variant
    before = dict(fl.VARIANT_LAUNCHES)
    leaf = pred.clone().requires_grad_(True)
    fl.fused_weighted_mse(leaf, target, w).backward()
    torch.cuda.synchronize()
    other = "row" if variant == "generic" else "generic"
    assert fl.VARIANT_LAUNCHES[variant] == before[variant] + 2
    assert fl.VARIANT_LAUNCHES[other] == before[other]


@pytest.mark.parametrize("geometry", ["video", "ragged"])
def test_one_forward_is_one_launch(cuda, geometry):
    from torch.profiler import ProfilerActivity, profile
    if geometry == "video":
        pred, target, w = _video_operands(cuda)
    else:
        pred, target, w = _operands(cuda, (3, 7, 9, 5), torch.float32, False)
    fl.launch_forward(pred, target, w)      # build, workspace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fl.launch_forward(pred, target, w)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "wmse_" in kernels[0][0]


def test_forward_is_bitwise_repeatable_at_the_video_geometry(cuda):
    pred, target, w = _video_operands(cuda)
    first = fl.launch_forward(pred, target, w)
    for _ in range(3):
        assert torch.equal(fl.launch_forward(pred, target, w), first)
    torch.testing.assert_close(first,
                               fl.weighted_mse_reference(pred, target, w),
                               rtol=1e-5, atol=0)


def test_kernels_match_plain_version_at_the_video_microbatch(cuda):
    """One microbatch of a gradAccum 4 video step at batch 64: (16,128,128,
    12) bf16 pred, (16,128,128,1) mask weights, sliced from the full batch
    as the step slices it; the row path, 32-bit offsets."""
    pred, target, w = (x[:16] for x in _video_operands(cuda))
    assert pred.shape == (16, 128, 128, 12) and w.shape == (16, 128, 128, 1)
    p = fl.plan(pred, target, w)
    assert (p.variant, p.index32) == ("row", True)
    _check_against_plain(cuda, pred, target, w)


def test_a_second_stream_gets_its_own_workspace_and_the_same_result(cuda):
    pred, target, w = _video_operands(cuda, b=8)
    ref = fl.launch_forward(pred, target, w)
    ref_grad = fl.launch_backward(pred, target, w,
                                  torch.tensor(1.3, device=cuda))
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [fl.launch_forward(pred, target, w) for _ in range(2)]
        grad = fl.launch_backward(pred, target, w,
                                  torch.tensor(1.3, device=cuda))
    side.synchronize()
    keys = [k for k in fl._WORKSPACES if k[0] == (cuda.index or 0)]
    assert (cuda.index or 0, side.cuda_stream) in keys and len(keys) >= 2
    assert all(torch.equal(g, ref) for g in got)
    assert torch.equal(grad, ref_grad)
    # the ticket is back at 0 after every call on either stream
    for ws, capacity in fl._WORKSPACES.values():
        assert ws[capacity:].view(torch.int32).item() == 0


def test_mixed_devices_raise(cuda):
    pred, target, w = _operands(cuda, (3, 7, 9, 5), torch.float32, False)
    with pytest.raises(ValueError):
        fl.fused_weighted_mse(pred, target, w.cpu())


def _tiny_batch(regime):
    rs = np.random.RandomState(3)

    def images(c):
        return torch.from_numpy(rs.rand(4, 128, 128, c).astype(np.float32)
                                * 2 - 1)

    if regime == "center":
        return {"real": images(3)}
    if regime == "video3d":
        mask = torch.zeros(4, 1, 32, 32, 1)
        mask[..., 8:20, 6:26, :] = 1.0
        return {"real": torch.from_numpy(rs.rand(4, 2, 32, 32, 3).astype(
            np.float32) * 2 - 1), "mask": mask}
    mask = torch.zeros(4, 128, 128, 1)
    mask[:, 40:80, 30:90] = 1.0
    return {"real": images(6), "mask": mask}


# the video3d family at the CPU suite's small depth (levels 3, 32x32 clips)
V3D = dict(predLen=2, fineSize=32, video3dLevels=3)


@pytest.mark.parametrize("regime,extra", [
    ("center", dict(overlapPred=4)),
    ("video", dict(predLen=2, weight_nomask=0.05)),
    ("video", dict(predLen=2, weight_nomask=0.0, wtgdl=0.1)),
    ("video3d", dict(V3D, weight_nomask=0.05)),
    ("video3d", dict(V3D, weight_nomask=0.0, wtgdl=0.1)),
], ids=["center", "video", "video_composite_gdl", "video3d",
        "video3d_composite_gdl"])
def test_tiny_step_on_the_card_matches_the_cpu(cuda, regime, extra):
    from video_filler_tpu_torch.train import step as tstep
    kw = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=4, wtl2=0.999,
              computeDtype="float32", **extra)
    batch = _tiny_batch(regime)
    metrics = {}
    for dev in ("cpu", "cuda"):
        opt = Opt(device=dev, **kw)
        state = tstep.init_train_state(opt, regime,
                                       torch.Generator().manual_seed(5))
        m = tstep.make_train_step(opt, regime)(
            state, {k: v.to(dev) for k, v in batch.items()})
        metrics[dev] = {k: v.item() for k, v in m.items()}
    for k, v in metrics["cpu"].items():
        assert metrics["cuda"][k] == pytest.approx(v, rel=1e-3, abs=1e-6), k


@pytest.mark.parametrize("regime,extra", [
    ("center", dict(overlapPred=4, conditionAdv=True)),
    ("center", dict(overlapPred=4, noiseGen=True, nz=5)),
    ("video", dict(predLen=2, weight_nomask=0.05, gradAccum=2)),
    ("video", dict(predLen=2, weight_nomask=0.05, remat=1)),
    ("center", dict(overlapPred=4, adamMomentsBf16=True)),
    ("center", dict(overlapPred=4, useBias=True)),
], ids=["conditionAdv", "noiseGen", "gradAccum", "remat", "adamMomentsBf16",
        "useBias"])
def test_tiny_option_step_on_the_card_matches_the_cpu(cuda, regime, extra):
    """Each step option, one tiny f32 step on the card against the CPU from
    the same init (noiseGen on one fixed z)."""
    from video_filler_tpu_torch.train import step as tstep
    kw = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=4, wtl2=0.999,
              computeDtype="float32", **extra)
    batch = _tiny_batch(regime)
    z = torch.from_numpy(np.random.RandomState(4).normal(
        size=(4, 1, 1, 5)).astype(np.float32))
    metrics = {}
    for dev in ("cpu", "cuda"):
        opt = Opt(device=dev, **kw)
        state = tstep.init_train_state(opt, regime,
                                       torch.Generator().manual_seed(5))
        step = tstep.make_train_step(opt, regime)
        noise = z.to(dev) if opt.noiseGen else None
        m = step(state, {k: v.to(dev) for k, v in batch.items()},
                 noise=noise)
        metrics[dev] = {k: v.item() for k, v in m.items()}
    for k, v in metrics["cpu"].items():
        assert metrics["cuda"][k] == pytest.approx(v, rel=1e-3, abs=1e-6), k


# --- inference ------------------------------------------------------------

def _tiny_checkpoint(tmp_path, regime, **kw):
    """(CPU Opt, path): a tiny f32 port checkpoint, G's weights scaled by 2
    and its BN running statistics drawn away from their init values."""
    from video_filler_tpu_torch.checkpoint import ckpt
    from video_filler_tpu_torch.train import step as tstep
    opt = Opt(device="cpu", nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=2,
              computeDtype="float32", **kw)
    state = tstep.init_train_state(opt, regime,
                                   torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in state.gen.parameters():
            p.mul_(2.0)
        for name, b in state.gen.named_buffers():
            b.copy_(torch.rand(b.shape, generator=g) * 1.5 + 0.5
                    if name.endswith("running_var")
                    else torch.randn(b.shape, generator=g) * 0.3)
    return opt, ckpt.save_checkpoint(str(tmp_path), regime, 1, state)


INFER_REGIMES = {"center": (dict(overlapPred=4), (128, 128, 3)),
                 "video": (dict(predLen=2), (128, 128, 6)),
                 "wholeim": ({}, (128, 128, 27)),
                 "video3d": (V3D, (2, 32, 32, 3))}


@pytest.mark.parametrize("regime", list(INFER_REGIMES))
def test_load_generator_on_the_card_matches_the_cpu(cuda, tmp_path, regime):
    from video_filler_tpu_torch.eval.common import load_generator
    kw, shape = INFER_REGIMES[regime]
    opt, path = _tiny_checkpoint(tmp_path, regime, **kw)
    x = torch.from_numpy(np.random.RandomState(4).uniform(
        -1, 1, (2,) + shape).astype(np.float32))
    with torch.inference_mode():
        ref = load_generator(opt, regime, path, "cpu")(x)
        got = load_generator(opt.replace(device="cuda"), regime, path,
                             "cuda")(x.to(cuda))
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-5)


SERVE_MODES = {
    # name: (regime, options, ctx shape, mask boxes)
    "video_composite": ("video", {}, (2, 128, 128, 6), [(40, 80, 30, 90)]),
    "center_paste": ("center", {}, (2, 128, 128, 3), [(0, 128, 0, 128)]),
    "wholeim_patch": ("wholeim", {}, (2, 128, 128, 27), [(0, 128, 0, 128)]),
    "wholeim_frame": ("wholeim", dict(frameH=180, frameW=240),
                      (2, 180, 240, 3), [(30, 60, 40, 80)]),
    "video_frame_init": ("video", dict(frameH=180, frameW=240,
                                       withInit=True),
                         (2, 180, 240, 6), [(20, 70, 30, 90)]),
    "video3d_composite": ("video3d", {}, (2, 32, 32, 6), [(8, 20, 6, 26)]),
}


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serve_function_on_the_card_matches_the_cpu(cuda, tmp_path, mode):
    """uint8 within one level (card and CPU convolutions sum in another
    order) and equal outside the mask."""
    from video_filler_tpu_torch.serve import InpaintServer
    regime, kw, shape, boxes = SERVE_MODES[mode]
    opt, path = _tiny_checkpoint(tmp_path, regime,
                                 **INFER_REGIMES[regime][0])
    if kw.get("withInit"):
        kw = dict(kw, initName=path)
    rs = np.random.RandomState(7)
    ctx = rs.randint(0, 256, shape, np.uint8)
    mask = np.zeros(shape[:3] + (1,), np.uint8)
    for y0, y1, x0, x1 in boxes:
        mask[:, y0:y1, x0:x1] = 1
    out = {}
    for dev in ("cpu", "cuda"):
        srv = InpaintServer(opt.replace(device=dev, **kw), regime, path,
                            device_thread=False)
        try:
            out[dev] = srv._serve_fn(ctx, mask)
        finally:
            srv.close()
    diff = np.abs(out["cuda"].astype(int) - out["cpu"].astype(int))
    assert diff.max() <= 1
    if regime in ("video", "video3d"):
        outside = np.broadcast_to(mask == 0, ctx.shape)
        np.testing.assert_array_equal(out["cuda"][outside], ctx[outside])
