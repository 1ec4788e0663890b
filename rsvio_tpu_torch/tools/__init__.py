"""Command-line tools of the port: the accuracy matrix, the synthetic VO
demo, solver and component timers, the ATE and GNSS converters, and the
distributed weak-scaling table. Each is run as
``python -m rsvio_tpu_torch.tools.<name>`` and defaults to ``--device
cuda``."""
