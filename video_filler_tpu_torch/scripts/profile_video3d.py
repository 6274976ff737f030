"""Per-stage times of the video3d generator against 2-D convs of the same
widths (the counterpart of the JAX package's scripts/profile_video3d.py).

Each stage of the video3d G -- the (3,4,4)/(1,2,2) encoder convs, the
(T,4,4)-valid bottleneck pair, the (3,4,4)/(1,2,2) decoder transposed
convs -- runs alone at the training shapes (batch B, T=4 frames, 128x128,
bf16, ``channels_last_3d``, the layers of ops/layers3d.py with f32 weights
cast on every call, as in the step), forward and forward plus the input's
gradient.  Beside each, a 2-D conv of the same widths over the B*T frames
folded into the batch is the per-FLOP reference: a 3-D stage at parity does
3x the 2-D conv's FLOPs (temporal kernel 3) in 3x the time.  The
bottleneck's 2-D reference is a (4,4)-valid conv with the same FLOPs.

    python -m video_filler_tpu_torch.scripts.profile_video3d [BATCH]
        [device=cpu]

BATCH defaults to 32.  ``VF_SMOKE=1``: tiny widths in f32 at 32x32, for
the CPU.  On the card each time is CUDA events around 30 back-to-back
calls after a warm-up, under ``cudnn.benchmark`` (the train loop's
setting).  Prints one row per layer, then each 3-D row's per-FLOP ratio
to its 2-D reference, and a JSON line of the rows.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from video_filler_tpu_torch.ops.layers import Conv2d, ConvTranspose2d
from video_filler_tpu_torch.ops.layers3d import Conv3d, ConvTranspose3d
from video_filler_tpu_torch.scripts.common import (
    describe,
    smoke,
    split_args,
    time_ms,
    tool_device,
)

ITERS = 30


def conv_flops(batch, t, h, w, cin, cout, kt, kh, kw, sh):
    """MACs*2 of a (kt,kh,kw) conv at stride (1,sh,sh), SAME padding."""
    oh, ow = h // sh, w // sh
    return 2.0 * batch * t * oh * ow * cin * cout * kt * kh * kw


class Profiler:
    """Times layers and keeps their rows."""

    def __init__(self, device: torch.device, dtype: torch.dtype, iters: int):
        self.device, self.dtype, self.iters = device, dtype, iters
        self.rs = np.random.RandomState(0)
        self.rows: list[dict] = []

    def clip(self, *shape):
        """Uniform [-1,1) data of (B,[T,]H,W,C), as the layer takes it:
        NC[D]HW in channels-last memory (a permuted view, no copy)."""
        x = torch.from_numpy(self.rs.rand(*shape).astype(np.float32) * 2 - 1)
        x = x.to(self.device, self.dtype)
        return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))

    def bench(self, tag, layer, x, flops, pair, kind):
        """Forward, and forward plus the input's gradient (dW costs the
        same MACs as dX for a conv: the second time is scaled by 2x the
        forward FLOPs).  ``pair`` and ``kind`` match each 3-D row to its
        2-D reference by key, not by order."""
        layer.reset_parameters(torch.Generator().manual_seed(0))
        layer = layer.to(self.device).requires_grad_(False)
        with torch.no_grad():
            y = layer(x)
        g_out = torch.empty_like(y).uniform_(-1.0, 1.0)   # y's strides
        xg = x.detach().requires_grad_(True)

        def fwd():
            with torch.no_grad():
                layer(x)

        def fwd_dx():
            torch.autograd.grad(layer(xg), xg, g_out)

        tf = time_ms(fwd, self.iters, self.device) / 1e3
        tb = time_ms(fwd_dx, self.iters, self.device) / 1e3
        row = {"tag": tag, "pair": pair, "kind": kind, "gflops": flops / 1e9,
               "fwd_ms": tf * 1e3, "fwd_tfs": flops / tf / 1e12,
               "bwd_ms": tb * 1e3, "bwd_tfs": 2.0 * flops / tb / 1e12}
        self.rows.append(row)
        print(f"{tag:34s} fwd {row['fwd_ms']:8.3f} ms {row['fwd_tfs']:6.2f} "
              f"TF/s   fwd+dX {row['bwd_ms']:8.3f} ms {row['bwd_tfs']:6.2f} "
              "TF/s", flush=True)


def ratios(rows: list[dict]) -> list[str]:
    """Each 3-D row against the 2-D row sharing its pair key (the
    bottleneck's two 3-D convs both against the one equal-FLOP 2-D
    reference)."""
    refs = {r["pair"]: r for r in rows if r["kind"] == "2d"}
    out = []
    for r in rows:
        if r["kind"] != "3d":
            continue
        ref = refs.get(r["pair"])
        if ref is None:
            out.append(f"  {r['tag']:34s} (no 2D reference run)")
            continue
        out.append(f"  {r['tag']:34s} {r['fwd_tfs'] / ref['fwd_tfs']:5.2f}x "
                   f"fwd   {r['bwd_tfs'] / ref['bwd_tfs']:5.2f}x dX")
    return out


def main(argv: list[str]) -> list[dict]:
    words, opts = split_args(argv)
    device = tool_device(opts)
    if opts:
        raise SystemExit(f"unknown options {sorted(opts)}")
    b = int(words[0]) if words else 32
    t, nb, dt, s0, iters = 4, 4000, torch.bfloat16, 128, ITERS
    widths = [64, 64, 128, 256, 512]
    if smoke():
        b, nb, dt, s0, iters = 1, 64, torch.float32, 32, 2
        widths = [4, 4, 8, 8, 8]
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    print(describe(device), flush=True)
    print(f"batch {b}, T {t}, {s0}x{s0}, {dt}, widths {widths}, bottleneck "
          f"{nb}", flush=True)
    p = Profiler(device, dt, iters)

    # encoder: 3-D (3,4,4)/(1,2,2) against 2-D (4,4)/2 on B*T frames
    s, cin = s0, 3
    for i, w in enumerate(widths):
        p.bench(f"3D enc conv{i} {s}^2 {cin}->{w}",
                Conv3d(cin, w, (3, 4, 4), (1, 2, 2), (1, 1, 1), dt),
                p.clip(b, t, s, s, cin),
                conv_flops(b, t, s, s, cin, w, 3, 4, 4, 2), f"enc{i}", "3d")
        p.bench(f"2D ref conv{i} {s}^2 {cin}->{w}",
                Conv2d(cin, w, 4, 2, 1, dt), p.clip(b * t, s, s, cin),
                conv_flops(b * t, 1, s, s, cin, w, 1, 4, 4, 2), f"enc{i}",
                "2d")
        s //= 2
        cin = w

    # the bottleneck pair: (T,4,4)-valid convs in and out
    cb = widths[-1]
    fb = 2.0 * b * cb * nb * t * 16
    p.bench(f"3D bott conv ({t},4,4)v {cb}->{nb}",
            Conv3d(cb, nb, (t, 4, 4), 1, 0, dt), p.clip(b, t, 4, 4, cb), fb,
            "bott", "3d")
    p.bench(f"2D ref bott (4,4)v {cb}->{nb}", Conv2d(cb, nb, 4, 1, 0, dt),
            p.clip(b * t, 4, 4, cb), fb, "bott", "2d")
    p.bench(f"3D up0 convT ({t},4,4)v {nb}->{cb}",
            ConvTranspose3d(nb, cb, (t, 4, 4), 1, 0, dt),
            p.clip(b, 1, 1, 1, nb), fb, "bott", "3d")

    # decoder: 3-D transposed (3,4,4)/(1,2,2) against 2-D (4,4)/2
    s = 4
    for i, w in enumerate(widths[::-1][1:] + [3], start=1):
        p.bench(f"3D dec up{i} {s}^2 {cin}->{w}",
                ConvTranspose3d(cin, w, (3, 4, 4), (1, 2, 2), (1, 1, 1), dt),
                p.clip(b, t, s, s, cin),
                conv_flops(b, t, s * 2, s * 2, w, cin, 3, 4, 4, 2), f"dec{i}",
                "3d")
        p.bench(f"2D ref up{i} {s}^2 {cin}->{w}",
                ConvTranspose2d(cin, w, 4, 2, 1, dt),
                p.clip(b * t, s, s, cin),
                conv_flops(b * t, 1, s * 2, s * 2, w, cin, 1, 4, 4, 2),
                f"dec{i}", "2d")
        s *= 2
        cin = w

    print("\nper-FLOP ratio (3D vs matching 2D, fwd / fwd+dX):")
    print("\n".join(ratios(p.rows)))
    print(json.dumps({"profile_video3d": p.rows, "batch": b,
                      "device": str(device)}), flush=True)
    return p.rows


if __name__ == "__main__":
    main(sys.argv[1:])
