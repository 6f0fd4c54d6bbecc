"""``host_us_per_launch`` (layer: round; the file also reads the name's
``.device`` split): host us inside the program's ``engine.chunk`` spans
(the whole of ``run_rounds``) in the traced slice, over the slice's device
kernels, memcpys and memsets (rank 0's card)."""

from perfbench import phases


def read(r):
    got = phases.totals(r)
    if got is None:
        return None
    return phases.total_ns(got, "engine.chunk") / 1e3 / r.summary["launches"]
