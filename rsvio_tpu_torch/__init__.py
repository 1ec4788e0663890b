"""rsvio_tpu_torch — the PyTorch / CUDA port of rsvio_tpu.

Module paths mirror the JAX package: the counterpart of ``rsvio_tpu/x/y.py``
is ``rsvio_tpu_torch/x/y.py``. The JAX package is the reference every
ported function is tested against; this package imports neither JAX nor
``rsvio_tpu`` at run time. Functions that make tensors default to
``device="cuda"``; the CPU is asked for explicitly.

It ports all of ``rsvio_tpu``: the stereo VO main path (``ops.lie``,
``ops.cameras``, ``ops.projection``, ``ops.pyramid``, ``ops.detect``,
``ops.klt``, ``models.frontend``, ``models.pnp``, ``models.ba``,
``models.estimator``, ``utils.precision``, ``utils.convert``,
``data.bench_scene``) and the tracker family (SE2 rotation tracking,
``ops.klt.track_points``, the gather KLT route with ``ops.interp`` bilinear
/ bicubic sampling, the ratio pyramid, Shi-Tomasi and NMS detection,
``models.mono_tracker``), the shipped VO configs (``utils.config``) and
every VO estimator option, window marginalization
(``models.marginalization``, ``models.ba.solve_ba_marginalized``) among
them, and the dataset command lines (``cli.run_euroc``, ``run_tum``,
``run_4seasons``, ``run_tartanair`` with ``cli.run`` / ``cli.playback``, the
players and OpenCV-free PNG reader of ``data.players`` / ``data.png``,
``utils.trajectory``, ``utils.checkpoint``, ``utils.observer``,
``profiling`` and the rerun and artifact viewers of ``viewers``), and the
visual-inertial estimator (``models.imu``, ``models.vio_ba``,
``models.estimator_vio``, ``make_estimator_config(kind= "vio")``, ``--vio``)
with the synthetic IMU scenes of ``data.synthetic``, the distributed layer
(``parallel``), and the evaluation harness (``utils.evaluation``) with its
tools (``tools``: the accuracy matrix, solver and component timers, ATE and
GNSS converters, the weak-scaling table, the synthetic VO demo, the
fused-vs-composed tracker A/B). What it replaces instead of porting: JAX's
compile cache, ``jax_trace`` (``profiling.torch_trace``), the
matmul-precision switch (``utils.precision.pin_fp32``), the native PNG
loader (``data.png``) and the Pallas internals. Both TPU kernels of the JAX
package have hand-written Hopper counterparts in ``ops.cuda.klt_kernel``
(source in ``csrc/``): the fused bidirectional KLT ``klt_bidir``
(translation and rotation) and the per-level ``klt_level``. The VO, VIO
and mono steps also run compiled, as JAX's jitted steps do:
``models.estimator.make_compiled_estimator_step``,
``models.estimator_vio.make_compiled_vio_estimator_step`` and
``models.mono_tracker.make_compiled_mono_step`` replay CUDA graphs of the
steps' segments (``utils.graphs``).
"""
