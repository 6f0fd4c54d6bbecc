"""``adam_roofline`` (layer: kernels): Adam's byte bound as a share of the
device time of the Adam kernels in the traced slice (rank 0's card).

Bytes: ``roofline.adam_bytes`` of the parameters one rank updates a round
(``modes/<mode>.py:adam_elements_per_round``) over the slice's rounds, at
the HBM bandwidth.  Kernels: any whose name holds "adam" (any case), so a
fused replacement is caught too.
"""

from perfbench import roofline


def _adam(name):
    return "adam" in name.lower()


def read(r):
    ns = r.device_ns(_adam)
    if not ns:
        return None
    nbytes = roofline.adam_bytes(r.mode.adam_elements_per_round(r.cfg, r.traffic) * r.rounds,
                                 r.cfg["moment_dtype"])
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / (ns / 1e9)
