import torch

from video_filler_tpu_torch.models.context_encoder import (  # noqa: F401
    Discriminator,
    DiscriminatorSpec,
    Generator,
    GeneratorSpec,
    build_discriminator,
    build_generator,
    specs_for_regime,
)


def build_for_regime(opt, regime: str, gen: torch.Generator | None = None
                     ) -> tuple[Generator, Discriminator]:
    """(generator, discriminator) for a regime, on the CPU, initialised from
    ``gen`` (G's weights drawn first, then D's)."""
    gspec, dspec = specs_for_regime(opt, regime)
    gen = gen or torch.Generator().manual_seed(0)
    return build_generator(gspec, gen), build_discriminator(dspec, gen)
