"""Command lines of the port: ``python -m rsvio_tpu_torch.cli.run_euroc``,
``run_tum``, ``run_4seasons`` (stereo VO, ``cli.run``) and ``run_tartanair``
(mono tracking)."""
