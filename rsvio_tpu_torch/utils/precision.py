"""Full-fp32 pins for the port.

The estimator's numerics — triangulation, J^T J normal equations, Lie
retraction chains — lose enough precision under reduced-precision matrix
products to corrupt the trajectory: the JAX reference measured 32% drift of
travelled distance with bf16-truncated products against 5% with full fp32
(see rsvio_tpu/utils/precision.py and docs/NOTES.md, "Matmul-precision
finding"). On an NVIDIA card the equivalent hazard is TF32: cuBLAS float32
products may use it when allowed, and cuDNN float32 convolutions use it by
default. Every product in this pipeline is tiny and latency-bound, so full
fp32 costs nothing measurable.

A function rather than an import side effect, so that importing the package
never changes process-wide settings; ``models.estimator.make_estimator_step``
calls it when it builds the step.
"""

from __future__ import annotations

import torch


def pin_fp32() -> None:
    """Disable TF32 in cuBLAS and cuDNN and ask for "highest" float32
    matmul precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
