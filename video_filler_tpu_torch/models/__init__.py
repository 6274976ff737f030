import torch

from video_filler_tpu_torch.models import context_encoder
from video_filler_tpu_torch.models.context_encoder import (  # noqa: F401
    ConditionalDiscriminator,
    Discriminator,
    DiscriminatorSpec,
    Generator,
    GeneratorSpec,
)
from video_filler_tpu_torch.models.context_encoder_3d import (  # noqa: F401
    Discriminator3D,
    Generator3D,
    Video3DSpec,
)
from video_filler_tpu_torch.ops.layers import reset_parameters


def video3d_fine_size(opt) -> int:
    """The 3-D family's square input side, 4 * 2**video3dLevels: serve,
    eval and the fineSize check read it here instead of re-deriving it."""
    return Video3DSpec(levels=opt.video3dLevels).fine_size


def video3d_spec(opt) -> Video3DSpec:
    """The 3-D family's spec from the options.  conditionAdv and noiseGen
    are 2-D joins the family has not (the JAX package refuses them too)."""
    if opt.conditionAdv or opt.noiseGen:
        raise ValueError("conditionAdv and noiseGen are 2-D generator joins "
                         "(train.lua:107-150); regime=video3d has neither")
    return Video3DSpec(nc=opt.nc, pred_len=opt.predLen, nef=opt.nef,
                       ngf=opt.ngf, ndf=opt.ndf, n_bottleneck=opt.nBottleneck,
                       levels=opt.video3dLevels, use_bias=opt.useBias,
                       dtype=opt.computeDtype)


def check_fine_size(opt, regime: str) -> None:
    """The step crops clips to fineSize; the 3-D G takes 4 * 2**levels.  A
    mismatch raises here, naming both, instead of running a wrong shape."""
    if regime == "video3d" and opt.fineSize != video3d_fine_size(opt):
        raise ValueError(
            f"regime=video3d needs fineSize = 4*2**video3dLevels = "
            f"{video3d_fine_size(opt)}, got fineSize={opt.fineSize} with "
            f"video3dLevels={opt.video3dLevels}")


def specs_for_regime(opt, regime: str):
    """(G spec, D spec) for a regime: the 2-D ``GeneratorSpec`` and
    ``DiscriminatorSpec``, or the 3-D family's one ``Video3DSpec`` twice.
    An option the regime refuses (conditionAdv or noiseGen on video3d)
    raises ValueError."""
    if regime == "video3d":
        spec = video3d_spec(opt)
        return spec, spec
    return context_encoder.specs_for_regime(opt, regime)


def _initialised(net: torch.nn.Module, gen: torch.Generator):
    """``net`` with the reference init (conv N(0,0.02), BN gamma
    N(1,0.02)) drawn from the CPU generator ``gen``."""
    reset_parameters(net, gen)
    return net


def build_generator(spec, gen: torch.Generator):
    """A generator of either family (by its spec) on the CPU, initialised
    from ``gen``."""
    cls = Generator3D if isinstance(spec, Video3DSpec) else Generator
    return _initialised(cls(spec), gen)


def build_discriminator(spec, gen: torch.Generator):
    """A discriminator of either family (by its spec), the conditionAdv one
    where the spec asks for it, on the CPU, initialised from ``gen``."""
    if isinstance(spec, Video3DSpec):
        cls = Discriminator3D
    elif spec.condition_adv:
        cls = ConditionalDiscriminator
    else:
        cls = Discriminator
    return _initialised(cls(spec), gen)


def build_for_regime(opt, regime: str, gen: torch.Generator | None = None):
    """(generator, discriminator) for a regime, on the CPU, initialised from
    ``gen`` (G's weights drawn first, then D's)."""
    if opt.seqParallel > 1:
        raise NotImplementedError(
            "seqParallel>1 (sequence-parallel video3d, parallel/temporal.py) "
            "is not ported yet (ROADMAP A.14)")
    gspec, dspec = specs_for_regime(opt, regime)
    gen = gen or torch.Generator().manual_seed(0)
    return build_generator(gspec, gen), build_discriminator(dspec, gen)
