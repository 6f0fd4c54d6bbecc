"""Real-batch sampling: the CUDA kernel's wrapper and its plain version.

Port of ``mdgan_tpu/ops/sampling.py`` (the Pallas ``_sample_kernel``,
``:27-48``, launched by ``sample_normalize``, ``:51-94``): for each worker,
gather b uint8 rows by index from the (N, S, H, W, C) shard stack and
normalize them to [-1, 1].  The port's result is NCHW, (N, b, C, H, W), the
layout its models take; ``csrc/sampling.cu`` folds that transpose into the
gather.  The indices may carry a leading round axis, (T, N, b): the engine
gathers a whole chunk of rounds in one launch, as the JAX engine's
``lax.scan`` covers a chunk.  For a CUDA tensor :func:`sample_normalize`
launches the kernel or raises; the plain version runs only for CPU tensors.
"""

from __future__ import annotations

import torch

from mdgan_tpu_torch.ops import _build
from mdgan_tpu_torch.ops.losses import normalize_uint8


def sample_normalize_plain(shards: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather, ``normalize_uint8`` and NHWC -> NCHW, in PyTorch; idx (N, b)
    or (T, N, b)."""
    n = shards.shape[0]
    rows = shards[torch.arange(n, device=shards.device)[:, None], idx.long()]
    return normalize_uint8(rows).movedim(-1, -3).contiguous()


def _check(shards, idx) -> None:
    if shards.dtype != torch.uint8 or shards.dim() != 5:
        raise ValueError("sample_normalize: shards must be (N, S, H, W, C) uint8, "
                         f"got {tuple(shards.shape)} {shards.dtype}")
    if idx.dtype != torch.int32 or idx.dim() not in (2, 3) or idx.shape[-2] != shards.shape[0]:
        raise ValueError(f"sample_normalize: idx must be (N={shards.shape[0]}, b) or "
                         f"(T, N={shards.shape[0]}, b) int32, got {tuple(idx.shape)} {idx.dtype}")
    if not (shards.is_contiguous() and idx.is_contiguous()):
        raise ValueError("sample_normalize: shards and idx must be contiguous")
    if idx.device != shards.device:
        raise ValueError(f"sample_normalize: idx on {idx.device}, shards on {shards.device}")


def sample_normalize(shards: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """shards (N, S, H, W, C) uint8, idx (N, b) or (T, N, b) int32 ->
    (N, b, C, H, W) or (T, N, b, C, H, W) float32."""
    _check(shards, idx)
    if shards.device.type == "cpu":
        return sample_normalize_plain(shards, idx)
    if shards.device.type != "cuda":
        raise ValueError(f"sample_normalize: unsupported device {shards.device}")
    if shards.device.index != torch.cuda.current_device():
        raise ValueError(f"sample_normalize: tensors on {shards.device}, current "
                         f"device is cuda:{torch.cuda.current_device()}")
    n, s, h, w, c = shards.shape
    out = torch.empty((*idx.shape, c, h, w), dtype=torch.float32, device=shards.device)
    _build.launch("mdgan_sample_normalize_u8", shards.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), idx.numel(), n, idx.shape[-1], s, h * w, c,
                  torch.cuda.current_stream(shards.device).cuda_stream)
    return out
