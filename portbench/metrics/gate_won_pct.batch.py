"""gate_won_pct, read in the adaptive cell: the share of gated frames on
which the RANSAC gate found its consensus, 100 x pnp_gate.won /
pnp_gate.frames (profiling.counter_sums; warm-up's frames included). None
where the program has no gate counter or counted no gated frame."""


def read(run):
    try:
        from rsvio_tpu_torch import profiling
    except ImportError:
        return None
    sums = getattr(profiling, "counter_sums", dict)()
    if sums.get("pnp_gate.frames", 0) <= 0:
        return None
    return 100.0 * sums["pnp_gate.won"] / sums["pnp_gate.frames"]
