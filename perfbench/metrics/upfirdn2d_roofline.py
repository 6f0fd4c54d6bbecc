"""``upfirdn2d_roofline`` (layer: kernels): the FIR resampling's byte bound
as a share of the device time of the kernels whose names hold "upfirdn2d"
in the traced slice (rank 0's card).

Bytes: the configuration's frozen ``upfirdn2d_bytes_per_sample`` (each
resampling's input read once and output written once, a sample and pass,
counted from the reference's own calls: ``configs/<family>.py``
``upfirdn2d_bytes``), summed over a round's passes as
``modes/<mode>.py:flops_per_round`` sums FLOPs, over the slice's rounds, at
the HBM bandwidth.  None where the slice has no such kernel or the
configuration no such count."""

from perfbench import roofline


def read(r):
    ns = r.device_ns(lambda name: "upfirdn2d" in name)
    per_sample = r.cfg.get("upfirdn2d_bytes_per_sample")
    if not ns or per_sample is None:
        return None
    per_round = r.mode.flops_per_round({**r.cfg, "flops_per_sample": per_sample}, r.traffic)
    nbytes = per_round / r.world * r.rounds
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / (ns / 1e9)
