"""The port's ``solve_vio_ba`` against the JAX package's, on
tests/test_torch_vio_ba.py's window problem, with each of its options: the
chi^2 gate, observation weights, the desert bias factors and an invalid
interval (float64), and the default and gated solves in float32.
Tolerances as in tests/test_torch_vio_ba.py: float64 the same LM path and
results within 1e-8; float32 held to JAX's float64 optimum as that file's
docstring says.
"""

import jax
import numpy as np
import pytest
import torch

from rsvio_tpu.models import vio_ba as jvb
from rsvio_tpu_torch.models import vio_ba as tvb
from test_torch_vio_ba import _check_result, _solve_args, problem  # noqa: F401

torch.set_num_threads(2)

CASES = {
    "default": (dict(), {}),
    "chi2_gate": (dict(chi2_gate=0.01), {}),
    "obs_weights": (dict(), dict(obs_weight=True)),
    "bias_alpha": (dict(bias_gyro_weight_desert=1e5,
                        bias_accel_weight_desert=1e6),
                   dict(bias_alpha=True)),
    "invalid_interval": (dict(), dict(invalid=1)),
}


@pytest.mark.parametrize("case,name", [(c, "f64") for c in CASES]
                         + [("default", "f32"), ("chi2_gate", "f32")])
def test_solve_vio_ba_matches_jax(problem, case, name):
    cfg_kw, extra = CASES[case]
    want = {}
    for n in {name, "f64"}:
        with jax.enable_x64(n == "f64"):
            args, kw = _solve_args(problem, n, extra, "jax")
            want[n] = jax.tree.map(np.asarray, jvb.solve_vio_ba(
                *args, cfg=jvb.VIOBAConfig(**cfg_kw), **kw))
    args, kw = _solve_args(problem, name, extra, "torch")
    got = tvb.solve_vio_ba(*args, cfg=tvb.VIOBAConfig(**cfg_kw), **kw)
    assert bool(got.success) and int(got.iterations) >= 2
    _check_result(got, want[name], None if name == "f64" else want["f64"])


