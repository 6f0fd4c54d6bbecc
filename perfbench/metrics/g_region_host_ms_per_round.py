"""``g_region_host_ms_per_round`` (layer: round; the file also reads the
name's ``.device`` split): host ms a round inside the program's generator
spans in the traced slice (rank 0), ``engine.generate`` (the round's G
forward) and ``engine.g_update`` (MD-GAN's cotangent, G backward and Adam;
standalone's G step: G forward, D forward, backward and Adam)."""

from perfbench import phases


def read(r):
    got = phases.totals(r)
    if got is None:
        return None
    return phases.total_ns(got, "engine.generate", "engine.g_update") / 1e6 / r.rounds
