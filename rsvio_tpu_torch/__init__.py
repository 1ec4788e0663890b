"""rsvio_tpu_torch — the PyTorch / CUDA port of rsvio_tpu.

Module paths mirror the JAX package: the counterpart of ``rsvio_tpu/x/y.py``
is ``rsvio_tpu_torch/x/y.py``. The JAX package is the reference every
ported function is tested against; this package imports neither JAX nor
``rsvio_tpu`` at run time.

Ported so far (the stereo VO main path): ``ops.lie``, ``ops.cameras``,
``ops.projection``, ``ops.pyramid``, ``ops.detect``, ``ops.klt`` with the
hand-written Hopper kernel ``ops.cuda.klt_kernel`` (source in ``csrc/``),
``models.frontend``, ``models.pnp``, ``models.ba``, ``models.estimator``,
``utils.precision``, ``utils.convert`` and ``data.bench_scene``.
"""
