"""Export a trained generator to a reference-format Torch7 ``.t7``
(counterpart of video_filler_tpu/eval/export.py): the write half of the
checkpoint exchange (checkpoint/t7.py), so a net trained here can be handed
back to the reference stack (util.load, demo.lua/test*.lua).

The checkpoint's G is read into the port's generator on the host, mapped
back to the JAX layout by checkpoint/convert.py and written by
``export_generator``: the file is byte for byte the JAX exporter's for the
same checkpoint.  No device work is done.

CLI:
    python -m video_filler_tpu_torch.eval.export regime=video \\
        net=checkpoints/exp1_20_state.npz out=exp1_netG.t7 [predLen=4 ...]
"""

from __future__ import annotations

import sys

import torch

from video_filler_tpu_torch.checkpoint import restore_subtree
from video_filler_tpu_torch.checkpoint.convert import state_dict_to_tree
from video_filler_tpu_torch.checkpoint.t7 import export_generator
from video_filler_tpu_torch.config import from_args
from video_filler_tpu_torch.eval.common import generator_spec
from video_filler_tpu_torch.models import Video3DSpec, build_generator


def main(argv: list[str]) -> None:
    regime, out, rest = "center", "netG.t7", []
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
        raise SystemExit("export needs net=<checkpoint .npz>")
    spec = generator_spec(opt, regime)
    if isinstance(spec, Video3DSpec):
        raise SystemExit(f"regime={regime}: the temporal 3-D family has no "
                         "Torch7 form (Torch7 nets are 2-D generators)")
    gen = restore_subtree(opt.net, build_generator(
        spec, torch.Generator().manual_seed(0)))
    params, bn_state = state_dict_to_tree(gen.state_dict())
    export_generator(params, bn_state, spec, out)
    print(f"wrote {out} (regime={regime}, from {opt.net})")


if __name__ == "__main__":
    main(sys.argv[1:])
