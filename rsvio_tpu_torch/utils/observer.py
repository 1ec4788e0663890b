"""Solver iteration observer: renders per-iteration LM metrics as a TSV
table (ref src/optimization/observer.rs:21-68: IterationMetrics{cost,
gradient_norm, damping, step_norm, step_quality} rows with a static
header), plus the accept flag.

The port's own copy of rsvio_tpu/utils/observer.py, the same text byte for
byte; `metrics` is a host array (a tensor's ``.cpu().numpy()``).
"""

from __future__ import annotations

import numpy as np

HEADER = ("iter\tcost\t\tgrad_norm\tlambda\t\tstep_norm\t"
          "step_quality\taccepted")


def format_metrics(metrics, iterations: int | None = None) -> str:
    """Render (max_iters, 6) [cost, gradient_norm, lambda, step_norm,
    step_quality, accepted] rows (older 4-column [cost, lambda, step_norm,
    accepted] buffers are still accepted)."""
    m = np.asarray(metrics)
    n = int(iterations) if iterations is not None else m.shape[0]
    lines = [HEADER]
    for i in range(min(n, m.shape[0])):
        if m.shape[1] >= 6:
            cost, gnorm, lam, step, rho, acc = m[i, :6]
        else:
            cost, lam, step, acc = m[i, :4]
            gnorm, rho = float("nan"), float("nan")
        lines.append(f"{i}\t{cost:.6e}\t{gnorm:.3e}\t{lam:.3e}\t"
                     f"{step:.3e}\t{rho:.3f}\t\t{'yes' if acc > 0 else 'no'}")
    return "\n".join(lines)


def print_metrics(metrics, iterations: int | None = None) -> None:
    print(format_metrics(metrics, iterations))
