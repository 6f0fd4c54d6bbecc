"""FIR resampling (upfirdn2d): the CUDA kernel's wrapper, its plan, its
plain version and its gradient.

StyleGAN2 config-f (``models/stylegan2f.py``) upsamples and blurs through
``upfirdn2d`` (NVlabs/stylegan2, ``dnnlib/tflib/ops/upfirdn_2d.py``): each
plane of an (N, C, H, W) tensor is upsampled by ``up`` (zeros inserted),
padded by ``pad = (x0, x1, y0, y1)`` (negative pads crop), convolved with the
2-D FIR ``k`` (a true convolution) and downsampled by ``down``:

    out = (in * up + pad0 + pad1 - k) // down + 1      (each direction)

For a CUDA tensor (float32 or bfloat16) :func:`upfirdn2d` launches the
kernel of ``csrc/upfirdn2d.cu`` once a call (a float32 sum, one rounding) or
raises: the kernel is compiled for the models' resamplings only, a 4x4
filter with (up, down) in ``KERNEL_FACTORS``.  :func:`plan` cuts the call
into blocks from its shape and layout.  A channels_last input whose channels
are a multiple of ``NHWC_CHANNELS`` (:func:`takes_nhwc`) is read as it lies
(``nhwc``: a tile of output pixels and a chunk of channels a block, the
output channels_last too); any other input is made contiguous and cut into
planes (``rows``: full output rows of one plane; ``planes``: several whole
small planes).  A block stages its padded, upsampled input in shared memory
once, and each thread computes a patch of outputs from it.  The launches are
counted in ``_build.launches``, also by plan (``mdgan_upfirdn2d/nhwc``).  The
plain version (``F.pad`` and a depthwise ``F.conv2d``, in float32, or
float64 for float64 input) runs only for CPU tensors, and returns the layout
the kernel would.  The gradient is the same operation with the filter
flipped, ``up`` and ``down`` swapped and the pads that give back the input's
size (:func:`grad_pad`, NVlabs' ``_upfirdn_2d_cuda``), so the backward
launches the same kernel, by the plan its ``dy``'s layout takes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mdgan_tpu_torch.ops import _build

Pad = Tuple[int, int, int, int]
KERNEL_TAPS = (4, 4)
KERNEL_FACTORS = ((1, 1), (2, 1), (1, 2))  # (up, down); a gradient swaps them
XB, RY = 4, 8              # a thread's patch: RY rows of XB outputs (the kernel's kXB, kRY)
THREADS = 256              # the most threads a block (the kernel's kMaxThreads)
STAGE_FLOATS = 16          # float32 a thread stages in one batch: 4 loads of 16 B (kBatch)
SMALL_W = 32               # out_w at or under which blocks pack whole planes
BLOCK_SMEM = 48 * 1024     # shared memory a block takes, where one row group fits in it
ROWS_SMEM = 232448         # the H100's per-block limit (over 48 KB the launch opts in)
MIN_BLOCKS = 2 * 132       # two blocks for each of the H100's SMs, where the call has the work
NHWC_CHANNELS = 8          # channels a channels_last input needs a multiple of for the nhwc plan
NHWC_RY, NHWC_XB = 1, 4    # an nhwc thread's output pixels (the kernel's kNhwcRY, kNhwcXB)
NHWC_VECTORS = 8           # 16-byte channel vectors an nhwc block at most (128 B of a pixel)
NHWC_TILE_H, NHWC_TILE_W = 8, 16  # output rows and columns an nhwc block at most
NHWC_THREADS = 64          # the fewest threads an nhwc block is cut down to for more blocks
PLAN_KINDS = {"rows": 0, "planes": 1, "nhwc": 2}  # the C entry point's ``kind``


class Plan(NamedTuple):
    """How the kernel cuts one call into blocks (see ``csrc/upfirdn2d.cu``)."""
    name: str              # "rows", "planes" or "nhwc": the kernel is upfirdn2d_<name>
    tile_h: int            # output rows a block computes of each of its planes
    planes_per_block: int
    threads: int
    pitch: int             # floats a staged row (nhwc: staged pixels a row)
    stage_rows: int        # staged rows a plane
    grid: int              # blocks
    smem: int              # shared memory a block, bytes
    smem_limit: int        # what this plan allows itself
    tile_w: int = 0        # nhwc: output columns a block
    vectors: int = 0       # nhwc: 16-byte channel vectors a block


@functools.lru_cache(maxsize=256)  # a model makes a few dozen shapes; a Plan is immutable
def plan(planes: int, out_h: int, out_w: int, up: int, down: int, channels: int = 0,
         itemsize: int = 4) -> Plan:
    """The kernel's blocks for ``planes`` planes of ``out_h`` x ``out_w``
    outputs at (``up``, ``down``).  ``channels`` > 0: the input lies
    channels_last with that many channels a sample (``planes`` / ``channels``
    samples) of ``itemsize``-byte elements, and takes the ``nhwc`` plan
    (:func:`_plan_nhwc`); it must then be a multiple of ``NHWC_CHANNELS``.
    Else a block stages ``stage_rows`` rows of ``pitch`` float32 columns a
    plane, the upsampled, padded rows its outputs' 4x4 taps reach, and its
    threads compute patches of ``RY`` x ``XB`` outputs from them.  Outputs
    ``out_w`` <= ``SMALL_W`` wide pack whole planes into a block
    (``planes``); wider ones take ``tile_h`` full rows of one plane a block
    (``rows``), the tiles of a plane of even height.  A block grows as far
    as ``THREADS`` patches, 48 KB of shared memory (where a row group fits)
    and ``MIN_BLOCKS`` blocks in the call (where it has the work) allow, and
    has threads enough to stage its rows in one batch of ``STAGE_FLOATS`` a
    thread where ``THREADS`` allow.  ``up`` only names the kernel: the
    staged columns are counted in the upsampled plane."""
    if channels:
        return _plan_nhwc(planes, channels, out_h, out_w, up, down, itemsize)
    if min(planes, out_h, out_w) <= 0 or (up, down) not in KERNEL_FACTORS:
        raise ValueError(f"upfirdn2d plan: {planes} planes of {out_h}x{out_w} at "
                         f"(up, down) ({up}, {down})")
    col_groups, plane_groups = -(-out_w // XB), -(-out_h // RY)
    # the last patch reads float4s from column (col_groups - 1) * XB * down
    pitch = (col_groups - 1) * XB * down + -(-((XB - 1) * down + 4) // 4) * 4

    def stage_rows(tile_h):
        return (tile_h - 1) * down + 4

    def threads(patches, rows):  # rows: staged rows a block
        return _warps(max(patches, -(-rows * pitch // (up * STAGE_FLOATS))))

    if out_w <= SMALL_W:
        tile_h = plane_groups * RY
        plane_bytes = 4 * stage_rows(tile_h) * pitch
        per_plane = col_groups * plane_groups
        if plane_bytes <= BLOCK_SMEM and per_plane <= THREADS:
            pb = max(1, min(THREADS // per_plane, BLOCK_SMEM // plane_bytes,
                            -(-planes // MIN_BLOCKS)))
            return Plan("planes", tile_h, pb, threads(pb * per_plane, pb * stage_rows(tile_h)),
                        pitch, stage_rows(tile_h), -(-planes // pb), pb * plane_bytes,
                        BLOCK_SMEM)
    row_groups = max(1, min(THREADS // col_groups, plane_groups))
    while row_groups > 1 and (4 * stage_rows(row_groups * RY) * pitch > BLOCK_SMEM
                              or planes * -(-out_h // (row_groups * RY)) < MIN_BLOCKS):
        row_groups -= 1
    row_groups = -(-plane_groups // -(-plane_groups // row_groups))  # tiles of even height
    tile_h = row_groups * RY
    smem = 4 * stage_rows(tile_h) * pitch
    if smem > ROWS_SMEM:
        raise ValueError(f"upfirdn2d: rows {out_w} wide need {smem} B of shared memory a "
                         f"block, over {ROWS_SMEM}")
    return Plan("rows", tile_h, 1, threads(col_groups * row_groups, stage_rows(tile_h)), pitch,
                stage_rows(tile_h), planes * -(-out_h // tile_h), smem, ROWS_SMEM)


def _plan_nhwc(planes: int, channels: int, out_h: int, out_w: int, up: int, down: int,
               itemsize: int) -> Plan:
    """The ``nhwc`` plan: a block computes a ``tile_h`` x ``tile_w`` tile of
    output pixels of one sample for a chunk of ``vectors`` 16-byte channel
    vectors (channels innermost), from the ``stage_rows`` x ``pitch`` pixels
    of the upsampled, padded input its taps reach, staged in shared memory
    as they lie; a thread computes ``NHWC_RY`` x ``NHWC_XB`` outputs of one
    vector.  A chunk is the most vectors up to ``NHWC_VECTORS`` that divide
    the channels, a tile at most ``NHWC_TILE_H`` x ``NHWC_TILE_W``, within
    ``THREADS`` and 48 KB of staged pixels; where the call makes fewer than
    ``MIN_BLOCKS`` blocks, tiles shrink (rows first) while a block keeps
    ``NHWC_THREADS``."""
    vec = 16 // itemsize
    if (channels <= 0 or channels % NHWC_CHANNELS or planes % channels or itemsize not in (2, 4)
            or min(planes, out_h, out_w) <= 0 or (up, down) not in KERNEL_FACTORS):
        raise ValueError(f"upfirdn2d nhwc plan: {planes // max(channels, 1)} samples of "
                         f"{channels} channels of {itemsize} B, {out_h}x{out_w} outputs at "
                         f"(up, down) ({up}, {down})")
    nvec = channels // vec
    vectors = max(v for v in range(1, NHWC_VECTORS + 1) if nvec % v == 0)
    samples, chunks = planes // channels, nvec // vectors

    def stage(tile):
        return (tile - 1) * down + 4

    def blocks(th, tw):
        return samples * chunks * -(-out_h // th) * -(-out_w // tw)

    def threads(th, tw):
        return vectors * (th // NHWC_RY) * (tw // NHWC_XB)

    def half(tile, unit):
        return max(unit, tile // 2 // unit * unit)

    th = min(NHWC_TILE_H, -(-out_h // NHWC_RY) * NHWC_RY)
    tw = min(NHWC_TILE_W, -(-out_w // NHWC_XB) * NHWC_XB)
    while ((threads(th, tw) > THREADS or 16 * vectors * stage(th) * stage(tw) > BLOCK_SMEM)
           and (th > NHWC_RY or tw > NHWC_XB)):
        if th >= tw and th > NHWC_RY or tw == NHWC_XB:
            th = half(th, NHWC_RY)
        else:
            tw = half(tw, NHWC_XB)
    while blocks(th, tw) < MIN_BLOCKS:
        if th > NHWC_RY and threads(half(th, NHWC_RY), tw) >= NHWC_THREADS:
            th = half(th, NHWC_RY)
        elif tw > NHWC_XB and threads(th, half(tw, NHWC_XB)) >= NHWC_THREADS:
            tw = half(tw, NHWC_XB)
        else:
            break
    smem = 16 * vectors * stage(th) * stage(tw)
    return Plan("nhwc", th, 1, threads(th, tw), stage(tw), stage(th), blocks(th, tw), smem,
                BLOCK_SMEM, tw, vectors)


def takes_nhwc(x: torch.Tensor) -> bool:
    """Whether the kernel reads ``x`` (N, C, H, W) as it lies, by the
    ``nhwc`` plan, and writes a channels_last output: ``x`` is
    channels_last, 16-byte aligned, with C a multiple of ``NHWC_CHANNELS``.
    Any other input is made contiguous for the NCHW plans."""
    return (x.shape[1] % NHWC_CHANNELS == 0 and x.is_contiguous(memory_format=torch.channels_last)
            and x.data_ptr() % 16 == 0)


def _warps(threads: int) -> int:
    return min(THREADS, 32 * -(-threads // 32))


def grad_pad(in_hw: Tuple[int, int], out_hw: Tuple[int, int], up: int, down: int, pad: Pad,
             taps: Tuple[int, int] = KERNEL_TAPS) -> Pad:
    """The pads of the gradient's resampling (filter flipped, ``up`` and
    ``down`` swapped) that take ``out_hw`` back to ``in_hw``."""
    (h, w), (oh, ow), (kh, kw) = in_hw, out_hw, taps
    x0, _, y0, _ = pad
    return (kw - x0 - 1, w * up - ow * down + x0 - up + 1,
            kh - y0 - 1, h * up - oh * down + y0 - up + 1)


def setup_kernel(taps: Sequence[float], gain: float = 1.0) -> np.ndarray:
    """The separable 2-D FIR of the 1-D ``taps``, normalized to sum 1, times
    ``gain`` (NVlabs' ``_setup_kernel``): [1, 3, 3, 1] gives StyleGAN2's."""
    t = np.asarray(taps, np.float64)
    k = np.outer(t, t)
    return (k / k.sum() * gain).astype(np.float32)


def out_size(n: int, up: int, down: int, pad0: int, pad1: int, taps: int) -> int:
    return (n * up + pad0 + pad1 - taps) // down + 1


def upfirdn2d_plain(x: torch.Tensor, k: np.ndarray, up: int = 1, down: int = 1,
                    pad: Pad = (0, 0, 0, 0)) -> torch.Tensor:
    """The operation in PyTorch: zeros inserted by reshape and ``F.pad``,
    the pads, then a depthwise ``F.conv2d`` with the flipped filter, in
    float32 (float64 for float64 input), cast back to ``x``'s dtype, in the
    layout the kernel returns (channels_last where :func:`takes_nhwc`).
    ``k`` may be a tensor: one already on ``x``'s device in the sum's dtype
    takes no copy from the host."""
    n, c, h, w = x.shape
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = x.to(dtype).reshape(n * c, 1, h, 1, w, 1)
    y = F.pad(y, (0, up - 1, 0, 0, 0, up - 1)).reshape(n * c, 1, h * up, w * up)
    y = F.pad(y, tuple(pad))
    taps = k if isinstance(k, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(k))
    weight = taps.to(y).flip(0, 1)[None, None]
    y = F.conv2d(y, weight, stride=down)
    layout = torch.channels_last if takes_nhwc(x) else torch.contiguous_format
    return y.reshape(n, c, y.shape[2], y.shape[3]).to(x.dtype, memory_format=layout)


def _launch(x: torch.Tensor, k: np.ndarray, up: int, down: int, pad: Pad) -> torch.Tensor:
    if k.shape != KERNEL_TAPS or (up, down) not in KERNEL_FACTORS:
        raise ValueError(f"upfirdn2d: the CUDA kernel takes a {KERNEL_TAPS} filter with "
                         f"(up, down) in {KERNEL_FACTORS}, got {k.shape} and ({up}, {down})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"upfirdn2d: CUDA input must be float32 or bfloat16, got {x.dtype}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"upfirdn2d: input on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    nhwc = takes_nhwc(x)
    x = x if nhwc else x.contiguous()
    n, c, h, w = x.shape
    kh, kw = k.shape
    oh = out_size(h, up, down, pad[2], pad[3], kh)
    ow = out_size(w, up, down, pad[0], pad[1], kw)
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last if nhwc else torch.contiguous_format)
    if y.numel() == 0:
        return y
    p = plan(n * c, oh, ow, up, down, c if nhwc else 0, x.element_size())
    taps = np.ascontiguousarray(k, np.float32)
    _build.launch("mdgan_upfirdn2d", x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
                  n * c, h, w, oh, ow, up, down, pad[0], pad[2], taps.ctypes.data, kh, kw,
                  PLAN_KINDS[p.name], p.tile_h, p.vectors if nhwc else p.planes_per_block,
                  p.threads, p.pitch, p.stage_rows, c, p.tile_w,
                  torch.cuda.current_stream(x.device).cuda_stream, plan=p.name)
    return y


def _apply(x: torch.Tensor, k: np.ndarray, up: int, down: int, pad: Pad) -> torch.Tensor:
    if x.device.type == "cpu":
        return upfirdn2d_plain(x, k, up, down, pad)
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d: unsupported device {x.device}")
    return _launch(x, k, up, down, pad)


class _UpFirDn2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k, up, down, pad):
        ctx.k, ctx.up, ctx.down, ctx.pad = k, up, down, pad
        ctx.in_hw = x.shape[2:]
        y = _apply(x, k, up, down, pad)
        ctx.out_hw = y.shape[2:]
        return y

    @staticmethod
    def backward(ctx, dy):
        gpad = grad_pad(ctx.in_hw, ctx.out_hw, ctx.up, ctx.down, ctx.pad, ctx.k.shape)
        dx = upfirdn2d(dy, ctx.k[::-1, ::-1], up=ctx.down, down=ctx.up, pad=gpad)
        return dx, None, None, None, None


def upfirdn2d(x: torch.Tensor, k: np.ndarray, up: int = 1, down: int = 1,
              pad: Pad = (0, 0, 0, 0)) -> torch.Tensor:
    """x (N, C, H, W) -> (N, C, out_h, out_w): upsample by ``up``, pad by
    ``pad`` = (x0, x1, y0, y1), convolve with the 2-D FIR ``k`` (a numpy
    array; :func:`setup_kernel`), downsample by ``down``; differentiable.
    The output is channels_last where :func:`takes_nhwc` holds for ``x``,
    else contiguous."""
    if x.dim() != 4:
        raise ValueError(f"upfirdn2d: x must be (N, C, H, W), got {tuple(x.shape)}")
    k = np.ascontiguousarray(k, np.float32)
    if k.ndim != 2:
        raise ValueError(f"upfirdn2d: the filter must be 2-D, got shape {k.shape}")
    return _UpFirDn2d.apply(x, k, int(up), int(down), tuple(int(p) for p in pad))

