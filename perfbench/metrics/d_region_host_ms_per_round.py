"""``d_region_host_ms_per_round`` (layer: round; the file also reads the
name's ``.device`` split, for a cell whose end-to-end metric is
``device_ms_per_round``): host ms a round inside the program's D-region
spans in the traced slice (rank 0), ``engine.d_step`` (each local epoch's
D forwards, backward, replica all-reduce and Adam launch) and
``engine.feedback`` (MD-GAN's feedback through the updated
discriminators)."""

from perfbench import phases


def read(r):
    got = phases.totals(r)
    if got is None:
        return None
    return phases.total_ns(got, "engine.d_step", "engine.feedback") / 1e6 / r.rounds
