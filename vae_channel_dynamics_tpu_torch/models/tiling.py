"""Tiled and sliced VAE inference (diffusers' ``enable_tiling`` and
``enable_slicing``), in PyTorch.

Counterpart of ``vae_channel_dynamics_tpu/models/tiling.py``, with its
semantics: the image is cut into overlapping tiles of one shape, each tile
runs through the encoder or decoder alone, and neighbouring tiles are
blended linearly over the overlap, so activation memory scales with the
tile and not the image.

- **Clamped last tiles.** Where the grid overruns the image, the last tile's
  start is clamped to ``size - tile``, so every tile has the full tile
  shape (diffusers' last tile is a smaller crop instead). Interior output is
  diffusers' blend; the border sees more context.
- **The diffusers blend** (autoencoder_kl ``tiled_encode``/``tiled_decode``):
  a per-axis linear ramp ``y / blend_extent``, vertical first, then
  horizontal, each against the UN-blended neighbour, then each tile gives
  its ``stride``-sized output cell; a per-neighbour row offset puts the
  clamped last tile's blend at its cell boundary.

The JAX package sweeps the tiles with ``lax.map`` so that XLA compiles one
tile program; in PyTorch a plain loop over the equal-shape tiles is the
idiom. Tensors are NHWC, as at the JAX functions; GroupNorm statistics are
per tile, the approximation diffusers makes too.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch


def tile_starts(size: int, tile: int, stride: int) -> List[int]:
    """Tile start offsets covering ``[0, size)``: diffusers' ``range(0,
    size, stride)`` with any start whose tile would overrun the image clamped
    to ``size - tile`` (so all tiles keep one shape)."""
    if tile <= 0 or stride <= 0:
        raise ValueError(f"tile ({tile}) and stride ({stride}) must be positive")
    if stride > tile:
        raise ValueError(f"stride ({stride}) must not exceed tile ({tile})")
    if size <= tile:
        return [0]
    n = math.ceil((size - tile) / stride) + 1
    return [min(k * stride, size - tile) for k in range(n)]


def _cell_bounds(starts: Sequence[int], size: int, stride: int) -> List[Tuple[int, int]]:
    """Output cell ``[begin, end)`` per tile: tile k owns ``[k*stride,
    (k+1)*stride)``, the last up to ``size`` (diffusers' ``row_limit``
    crop-and-cat)."""
    cells = []
    for k in range(len(starts)):
        begin = k * stride
        end = min((k + 1) * stride, size) if k < len(starts) - 1 else size
        cells.append((begin, end))
    return cells


def _blend_edge(prev: torch.Tensor, cur: torch.Tensor, axis: int, blend: int, cur_lo: int,
                prev_lo: int) -> torch.Tensor:
    """``cur`` with its rows ``[cur_lo, cur_lo + blend)`` along ``axis``
    blended linearly against ``prev``'s rows ``[prev_lo, prev_lo + blend)``:
    all ``prev`` at the first row, ramping to (almost) all ``cur``."""
    if blend <= 0:
        return cur
    cur_rows = cur.narrow(axis, cur_lo, blend)
    prev32 = prev.narrow(axis, prev_lo, blend).float()
    shape = [1] * cur.dim()
    shape[axis] = blend
    t = (torch.arange(blend, dtype=torch.float32, device=cur.device) / blend).reshape(shape)
    # prev + (cur - prev) * t: diffusers' prev * (1 - t) + cur * t, exact
    # where the two tiles agree
    mixed = (prev32 + (cur_rows.float() - prev32) * t).to(cur.dtype)
    pieces = []
    if cur_lo > 0:
        pieces.append(cur.narrow(axis, 0, cur_lo))
    pieces.append(mixed)
    if cur_lo + blend < cur.shape[axis]:
        pieces.append(cur.narrow(axis, cur_lo + blend, cur.shape[axis] - cur_lo - blend))
    return torch.cat(pieces, dim=axis)


def tiled_apply(
    fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    tile_in: int,
    stride_in: int,
    scale_num: int,
    scale_den: int,
) -> torch.Tensor:
    """Run ``fn`` (NHWC tile -> NHWC tile whose spatial size is ``in *
    scale_num / scale_den``) over an overlapping tile grid of ``x`` and
    blend the results. encode: scale 1/downsample factor; decode: upsample
    factor/1. Tile, stride and image size must divide by ``scale_den``."""
    n, h, w, _ = x.shape
    if tile_in % scale_den or stride_in % scale_den or h % scale_den or w % scale_den:
        raise ValueError(
            f"tile ({tile_in}), stride ({stride_in}) and image ({h}x{w}) must be "
            f"divisible by the model's spatial factor {scale_den}"
        )
    # an axis no larger than the tile stays whole
    tile_h, tile_w = min(tile_in, h), min(tile_in, w)
    sh = tile_starts(h, tile_h, min(stride_in, tile_h))
    sw = tile_starts(w, tile_w, min(stride_in, tile_w))
    if len(sh) == 1 and len(sw) == 1:
        return fn(x)

    def out(v: int) -> int:
        return v * scale_num // scale_den

    stride_out = out(stride_in)
    blend_h = out(tile_h) - stride_out if len(sh) > 1 else 0
    blend_w = out(tile_w) - stride_out if len(sw) > 1 else 0
    grid = [[fn(x[:, i:i + tile_h, j:j + tile_w, :]) for j in sw] for i in sh]

    cells_h = _cell_bounds(sh, out(h), stride_out)
    cells_w = _cell_bounds(sw, out(w), stride_out)
    sh_out = [out(s) for s in sh]
    sw_out = [out(s) for s in sw]
    rows = []
    for i in range(len(sh)):
        row = []
        for j in range(len(sw)):
            t = grid[i][j]
            # vertical then horizontal, each against the UN-blended
            # neighbour; the blend sits at the cell boundary (local row of
            # global row g in tile k is g - start_out[k])
            if i > 0:
                t = _blend_edge(grid[i - 1][j], t, axis=1, blend=blend_h,
                                cur_lo=cells_h[i][0] - sh_out[i],
                                prev_lo=cells_h[i][0] - sh_out[i - 1])
            if j > 0:
                t = _blend_edge(grid[i][j - 1], t, axis=2, blend=blend_w,
                                cur_lo=cells_w[j][0] - sw_out[j],
                                prev_lo=cells_w[j][0] - sw_out[j - 1])
            lo_h, hi_h = cells_h[i][0] - sh_out[i], cells_h[i][1] - sh_out[i]
            lo_w, hi_w = cells_w[j][0] - sw_out[j], cells_w[j][1] - sw_out[j]
            row.append(t[:, lo_h:hi_h, lo_w:hi_w, :])
        rows.append(torch.cat(row, dim=2))
    return torch.cat(rows, dim=1)


def sliced_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Run ``fn`` one batch element at a time (diffusers ``enable_slicing``):
    activation memory at the single-sample cost."""
    if x.shape[0] <= 1:
        return fn(x)
    return torch.cat([fn(x[i:i + 1]) for i in range(x.shape[0])], dim=0)


__all__ = ["sliced_apply", "tile_starts", "tiled_apply"]
