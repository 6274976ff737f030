"""The JAX package's measurement and gallery scripts and its experiment
recipes, ported (each keeps its script's name under ``scripts/``):
``profile_video3d`` (per-stage times of the video3d G), ``measure_remat``
(remat's memory and FLOPs), ``ablate_video3d_step`` (the video3d step
with f32 Adam or bf16 moments), ``render_gallery_lw`` (the logo and
wholeim gallery from the ``logo_wholeim`` ledger's checkpoints), and
``run_train_video.sh`` / ``run_test_video.sh``; and a diagnostic of the
held-out video ledger against the JAX package's run,
``bisect_heldout_video``.  Each tool runs as
``python -m video_filler_tpu_torch.scripts.<name>``, on the card unless
``device=cpu`` is passed; ``VF_SMOKE=1`` shrinks a measurement to a size
the CPU runs in seconds."""
