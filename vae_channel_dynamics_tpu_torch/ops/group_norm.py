"""GroupNorm (+ optional fused SiLU) for NCHW tensors.

Counterpart of ``vae_channel_dynamics_tpu/ops/group_norm.py``: the single
entry point the model uses. ``impl`` selects

* ``auto`` and ``xla``: :func:`group_norm_reference`, the plain path (the
  JAX package's ``_group_norm_xla``): fp32 sum and sum of squares per
  (sample, group) over (H, W, C/G), biased variance, ``rsqrt(var + eps)``,
  folded with the affine into per-(sample, channel) ``a``, ``b`` so that
  ``y = x*a + b``, then the optional SiLU, cast back to the input dtype. It
  deliberately avoids ``F.group_norm``: the kernels are held against this
  exact function. ``auto`` stays the plain path, as in the JAX package;
  whether it should pick the kernels on the H100 waits for a measurement.
* ``pallas``: the hand-written CUDA kernels of ``ops/group_norm_kernel.py``
  (the port of the JAX package's Pallas GroupNorm) with their autograd
  backward. It raises where the JAX kernels' ``eligible`` refuses the shape,
  so both packages accept the same configurations.
* ``fused``: the plain path, as in the JAX package: under ``fused`` the
  resnets that the gate admits run their norms inside the fused
  GroupNorm+SiLU+conv kernels (``ops/fused_resnet.py``, called from
  ``models/vae.py``), and every other norm reaches here and runs plain.

Under a spatial group (``ops/spatial_conv.py``) each rank holds a block of
the image's rows: both routes add their per-(sample, group) sums over the
group's ranks before the mean and the variance, which JAX gets from GSPMD's
partial sums, and count the whole image's H*W.

Under a tensor group (``ops/tensor_parallel.py``) each rank normalises its
block of the channels, whose groups are whole on it: no collective.
"""

from __future__ import annotations

import torch

from . import group_norm_kernel
from .spatial_conv import active_spatial_group, all_reduce_sum


def group_norm_reference(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float,
    fuse_silu: bool,
) -> torch.Tensor:
    orig_dtype = x.dtype
    b, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    cg = c // num_groups
    xf = x.float()
    xg = xf.reshape(b, num_groups, cg, h, w)
    n = h * w * cg
    s = xg.sum(dim=(2, 3, 4))  # (B, G)
    q = xg.square().sum(dim=(2, 3, 4))
    sp = active_spatial_group()
    if sp is not None:
        # the sums over every row shard (an all-reduce, which is its own
        # adjoint in the backward)
        s, q = all_reduce_sum(torch.stack([s, q]), sp).unbind(0)
        n *= sp.size
    mean = s / n
    var = q / n - mean.square()
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)  # (B, C)
    inv_c = inv.repeat_interleave(cg, dim=1)
    a = inv_c * scale.float()[None, :]
    off = bias.float()[None, :] - mean_c * a
    out = xf * a[:, :, None, None] + off[:, :, None, None]
    if fuse_silu:
        out = out * torch.sigmoid(out)
    return out.to(orig_dtype)


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    fuse_silu: bool = False,
    impl: str = "auto",
    shards: int = 1,
) -> torch.Tensor:
    """GroupNorm over an NCHW tensor, optionally fused with SiLU; ``impl``
    is ``auto``, ``xla``, ``pallas`` or ``fused`` (see the module
    docstring). ``x`` may be one of ``shards`` channel blocks of a tensor
    group, holding ``num_groups`` whole groups: the kernels' rule is judged
    on the whole layer."""
    if impl == "pallas":
        if not group_norm_kernel.eligible(x, num_groups, shards):
            raise RuntimeError(
                "group_norm impl 'pallas' requested for an ineligible shape "
                f"{tuple(x.shape)} with {num_groups} groups"
                + (f" (one of {shards} channel blocks)" if shards > 1 else "")
                + ": the kernels take "
                f"channels that are a multiple of {group_norm_kernel.CHANNEL_MULTIPLE} "
                f"and of the group count, and H*W a multiple of "
                f"{group_norm_kernel.HW_MULTIPLE} (the JAX kernels' rule)"
            )
        return group_norm_kernel.group_norm_silu(
            x, scale, bias, num_groups=num_groups, eps=eps, fuse_silu=fuse_silu
        )
    if impl not in ("auto", "xla", "fused"):
        raise ValueError(
            f"Unknown group_norm impl {impl!r}; expected 'auto', 'xla', "
            "'pallas' or 'fused'."
        )
    return group_norm_reference(x, scale, bias, num_groups, eps, fuse_silu)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


__all__ = ["group_norm", "group_norm_reference", "silu"]
