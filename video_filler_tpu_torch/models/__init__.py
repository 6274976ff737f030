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


def build_generator(spec, gen: torch.Generator, seq_group=None):
    """A generator of either family (by its spec) on the CPU, initialised
    from ``gen``; ``seq_group``: the 3-D family's sequence-parallel
    build."""
    if isinstance(spec, Video3DSpec):
        return _initialised(Generator3D(spec, seq_group), gen)
    return _initialised(Generator(spec), gen)


def build_discriminator(spec, gen: torch.Generator, seq_group=None):
    """A discriminator of either family (by its spec), the conditionAdv one
    where the spec asks for it, on the CPU, initialised from ``gen``."""
    if isinstance(spec, Video3DSpec):
        return _initialised(Discriminator3D(spec, seq_group), gen)
    if spec.condition_adv:
        return _initialised(ConditionalDiscriminator(spec), gen)
    return _initialised(Discriminator(spec), gen)


def check_seq_parallel(opt, regime: str) -> None:
    """seqParallel>1 preflight with the JAX package's words
    (video_filler_tpu/train/loop.py:198-212)."""
    if opt.seqParallel <= 1:
        return
    if regime != "video3d":
        raise ValueError("seqParallel requires regime=video3d "
                         "(the 2D regimes have no temporal axis)")
    if opt.predLen % opt.seqParallel:
        raise ValueError(f"predLen {opt.predLen} must divide by "
                         f"seqParallel {opt.seqParallel}")
    if opt.modelParallel > 1:
        raise ValueError("seqParallel and modelParallel are exclusive")


def build_for_regime(opt, regime: str, gen: torch.Generator | None = None,
                     mesh=None):
    """(generator, discriminator) for a regime, on the CPU, initialised from
    ``gen`` (G's weights drawn first, then D's, the same draws with or
    without a mesh).  ``mesh`` (parallel/mesh.py): the networks of one
    rank, with their collectives attached -- sequence-parallel temporal
    convs on a ('data','seq') mesh -- and their bottleneck still full
    (``shard_state`` cuts it)."""
    check_seq_parallel(opt, regime)
    gspec, dspec = specs_for_regime(opt, regime)
    gen = gen or torch.Generator().manual_seed(0)
    seq_group = None
    if mesh is not None and mesh.mesh_dim_names[1] == "seq":
        seq_group = mesh.get_group("seq")
    g = build_generator(gspec, gen, seq_group)
    d = build_discriminator(dspec, gen, seq_group)
    if mesh is not None:
        from video_filler_tpu_torch.parallel.mesh import parallelize
        parallelize(g, d, mesh)
    return g, d
