"""``layout_ms_per_round`` (layer: models): device ms a round (rank 0's
card) in layout conversions: cuDNN's NCHW/NHWC transposes around its NHWC
convolution kernels (``nchwToNhwcKernel``, ``nhwcToNchwKernel``) and its
generic tensor transform (``tensorTransformGeneric``), as the H100 trace
names them.  0 where the slice has device work and none of these."""

LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "tensorTransformGeneric")


def _layout(name):
    return any(k in name for k in LAYOUT_KERNELS)


def read(r):
    if not r.summary["launches"]:
        return None
    return r.device_ns(_layout) / 1e6 / r.rounds
