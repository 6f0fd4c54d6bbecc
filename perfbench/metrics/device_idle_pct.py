"""``device_idle_pct`` (layer: device): the share of the traced slice (rank
0's card) that no device kernel, memcpy or memset covers."""


def read(r):
    s = r.summary
    if not s["launches"]:
        return None
    return 100.0 * (1.0 - s["busy_ns"] / s["window_ns"])
