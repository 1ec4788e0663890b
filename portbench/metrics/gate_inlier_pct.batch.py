"""gate_inlier_pct, read in the adaptive cell: the winning consensus sizes
over the candidate observations on the frames the RANSAC gate won, 100 x
pnp_gate.inliers / pnp_gate.candidates (profiling.counter_sums; warm-up's
frames included). None where the program has no gate counter or the gate
won no frame."""


def read(run):
    try:
        from rsvio_tpu_torch import profiling
    except ImportError:
        return None
    sums = getattr(profiling, "counter_sums", dict)()
    if sums.get("pnp_gate.candidates", 0) <= 0:
        return None
    return 100.0 * sums["pnp_gate.inliers"] / sums["pnp_gate.candidates"]
