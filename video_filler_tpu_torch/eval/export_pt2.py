"""Export a trained generator as a ``torch.export`` program (``.pt2``):
the counterpart of video_filler_tpu/eval/export_hlo.py, which serializes
StableHLO.

The exported function is the uint8-boundary eval forward that serving
runs, with the checkpoint's weights inside the program and the batch fixed
at ``opt.batchSize``: uint8 context in, uint8 frames out, normalising and
denormalising included.  A ``.pt2`` reloads with ``torch.export.load`` and
runs without this package's model code or the checkpoint.  It is traced
on the port's ``device=``; XLA's cross-platform lowering (``platforms=``)
has no counterpart.

CLI:
    python -m video_filler_tpu_torch.eval.export_pt2 regime=video \\
        net=checkpoints/exp1_20_state.npz out=netG.pt2 batchSize=64 \\
        [device=cuda predLen=4 ...]

Reload:
    import torch
    g = torch.export.load("netG.pt2").module()
    out_u8 = g(ctx_u8)          # uint8 (B,H,W,C) -> uint8

Every served generator shape exports: video3d takes and returns
channel-folded uint8 clips (B,S,S,nc*predLen), serve.py's wire format;
a noiseGen artifact takes a second (B,1,1,nz) f32 input: g(ctx_u8, noise).
"""

from __future__ import annotations

import inspect
import sys

import torch
from torch import nn

from video_filler_tpu_torch.config import Opt, from_args, resolve_device
from video_filler_tpu_torch.eval.common import generator_spec, load_generator
from video_filler_tpu_torch.models import video3d_fine_size
from video_filler_tpu_torch.ops.image import (
    denormalize_to_uint8,
    normalize_uint8,
)
from video_filler_tpu_torch.ops.layers3d import fold_time, unfold_time


class ServedGenerator(nn.Module):
    """The eval-mode generator between uint8 boundaries: ``forward(ctx_u8)``
    or, for a noiseGen G, ``forward(ctx_u8, noise)`` -> uint8 of G's
    output (the folded clip for video3d)."""

    def __init__(self, gen: nn.Module, frames: int | None = None):
        super().__init__()
        self.gen = gen
        self.frames = frames          # video3d: unfold/fold around G

    def forward(self, ctx_u8: torch.Tensor, *noise: torch.Tensor):
        x = normalize_uint8(ctx_u8)
        if self.frames:
            y = fold_time(self.gen(unfold_time(x, self.frames)))
        else:
            y = self.gen((x, *noise) if noise else x)
        return denormalize_to_uint8(y.float())


def example_inputs(opt: Opt, regime: str, device: torch.device) -> tuple:
    """Zero inputs of the exported signature at batch ``opt.batchSize``."""
    spec = generator_spec(opt, regime)
    if regime == "video3d":
        fs = video3d_fine_size(opt)
        shape = (opt.batchSize, fs, fs, opt.nc * opt.predLen)
    else:
        shape = (opt.batchSize, opt.fineSize, opt.fineSize, spec.nc_in)
    args = (torch.zeros(shape, dtype=torch.uint8, device=device),)
    if opt.noiseGen:
        args += (torch.zeros((opt.batchSize, 1, 1, opt.nz),
                             dtype=torch.float32, device=device),)
    return args


def export_generator(opt: Opt, regime: str, net_path: str,
                     gen: nn.Module | None = None):
    """``torch.export.export`` of the served forward of ``net_path``'s
    generator on ``opt.device`` (``gen``: that generator, already loaded by
    ``load_generator``); returns the ExportedProgram."""
    device = resolve_device(opt)
    if gen is None:
        gen = load_generator(opt, regime, net_path, device)
    module = ServedGenerator(
        gen, opt.predLen if regime == "video3d" else None).eval()
    kw = {}
    if "strict" in inspect.signature(torch.export.export).parameters:
        kw["strict"] = False    # trace the Python as it runs
    with torch.no_grad():
        return torch.export.export(module, example_inputs(opt, regime, device),
                                   **kw)


def main(argv: list[str]) -> None:
    regime, out, rest = "video", "netG.pt2", []
    for a in argv:
        k, _, v = a.partition("=")
        if k == "regime":
            regime = v
        elif k == "out":
            out = v
        else:
            rest.append(a)
    opt = from_args(rest)
    if not opt.net:
        raise SystemExit("export_pt2 needs net=<checkpoint .npz or .t7>")
    ep = export_generator(opt, regime, opt.net)
    torch.export.save(ep, out)
    print(f"wrote {out} (torch.export, device={opt.device}, "
          f"batch={opt.batchSize}, from {opt.net})")


if __name__ == "__main__":
    main(sys.argv[1:])
