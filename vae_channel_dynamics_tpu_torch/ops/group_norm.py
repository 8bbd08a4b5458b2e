"""GroupNorm (+ optional fused SiLU) for NCHW tensors, as plain tensor ops.

Counterpart of ``vae_channel_dynamics_tpu/ops/group_norm.py``. Only its
plain path (``_group_norm_xla``) is ported: fp32 sum and sum of squares per
(sample, group) over (H, W, C/G), biased variance, ``rsqrt(var + eps)``,
folded with the affine into per-(sample, channel) ``a``, ``b`` so that
``y = x*a + b``, then the optional SiLU, cast back to the input dtype. It
deliberately avoids ``F.group_norm``: the GroupNorm kernels still to be
ported are held against this exact function.
"""

from __future__ import annotations

import torch


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
) -> torch.Tensor:
    """GroupNorm over an NCHW tensor, optionally fused with SiLU.

    ``impl`` takes ``auto`` and ``xla`` (both the plain path, the JAX
    package's serving choice); ``pallas`` and ``fused`` name kernels that are
    not ported yet and raise rather than run another path."""
    if impl in ("pallas", "fused"):
        raise NotImplementedError(
            f"group_norm impl {impl!r} is not yet ported to PyTorch/CUDA; "
            "use 'auto' or 'xla'"
        )
    if impl not in ("auto", "xla"):
        raise ValueError(
            f"Unknown group_norm impl {impl!r}; expected 'auto' or 'xla'."
        )
    return group_norm_reference(x, scale, bias, num_groups, eps, fuse_silu)


__all__ = ["group_norm", "group_norm_reference"]
