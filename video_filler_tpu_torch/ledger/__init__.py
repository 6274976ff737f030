"""The learning-dynamics ledgers of the JAX package's ``scripts/``, ported:
``common`` (the protocol: ``run_ledger``, ``json_flusher``, ``score``),
``presets`` (every ledger and soak script's configuration), ``keepbest``
(the keepBest demo's checks), ``rescore`` (re-scoring a work directory's
checkpoints) and the command line, ``python -m
video_filler_tpu_torch.ledger``."""
