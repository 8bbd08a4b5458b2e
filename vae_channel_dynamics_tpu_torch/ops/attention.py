"""Single-head attention for the VAE mid block, and the ``auto`` policy.

Counterpart of ``vae_channel_dynamics_tpu/ops/attention.py``. All functions
take ``(batch, tokens, channels)`` like the JAX ones:

* :func:`naive_attention`: the full fp32 logits matrix, softmax in fp32,
  probabilities cast to the compute dtype before the product with ``v``;
* :func:`chunked_attention`: online softmax over key chunks, O(N * chunk)
  memory, fp32 running max / denominator / accumulator;
* ``flash`` (``ops/flash_attention.py``): the same online softmax in one
  CUDA kernel.

:func:`resolve_impl` and :func:`resolve_serving_impl` keep the JAX package's
token thresholds so that both packages choose the same impl for the same
shape. The thresholds were chosen from TPU measurements; they wait for H100
measurements before the port changes them.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention

# Finite stand-in for -inf: exp(-1e30 - m) underflows to 0 for any real m,
# but never produces the NaN that (-inf) - (-inf) would in the first step.
_MASKED = -1e30

# Same values as the JAX package's policy (see the module docstring).
AUTO_CHUNK_THRESHOLD = 4096
SERVING_FLASH_MIN_TOKENS = 4096
NAIVE_BWD_RESIDUAL_BUDGET_BYTES = int(1.25 * 2**30)
DEFAULT_CHUNK = 1024


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """``softmax(q @ k^T * scale) @ v`` with the full logits matrix."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    attn = torch.softmax(logits, dim=-1).to(out_dtype)
    return torch.matmul(attn, v.to(out_dtype))


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    out_dtype: torch.dtype,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Single-head softmax attention, online over key chunks.

    ``chunk`` is clamped to the key count; keys are zero-padded to a
    multiple of it and the padding is masked, so any token count works."""
    b, nq, _c = q.shape
    nk = k.shape[1]
    chunk = max(1, min(chunk, nk))
    pad = (-nk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qf = q.float()
    m = torch.full((b, nq, 1), _MASKED, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, nq, 1), dtype=torch.float32, device=q.device)
    # v may hold a block of the channels (a tensor group): the output's
    acc = torch.zeros((b, nq, v.shape[-1]), dtype=torch.float32, device=q.device)
    for start in range(0, nk + pad, chunk):
        kb = k[:, start:start + chunk]
        vb = v[:, start:start + chunk]
        s = torch.matmul(qf, kb.float().transpose(1, 2)) * scale
        if pad and start + chunk > nk:
            valid = torch.arange(start, start + chunk, device=q.device) < nk
            s = torch.where(valid, s, torch.full_like(s, _MASKED))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        # probabilities rounded to the compute dtype, product accumulated in fp32
        acc = acc * corr + torch.matmul(p.to(q.dtype).float(), vb.float())
        m = m_new
    return (acc / l).to(out_dtype)


def resolve_impl(
    attn_impl: str,
    num_tokens: int,
    channels: Optional[int] = None,
    batch: Optional[int] = None,
) -> str:
    """The ``auto`` policy for training-shaped calls: naive up to
    :data:`AUTO_CHUNK_THRESHOLD` tokens, naive above it while the backward's
    ``batch * tokens^2 * 4``-byte residual fits
    :data:`NAIVE_BWD_RESIDUAL_BUDGET_BYTES` (``batch=None`` counts as not
    fitting), chunked otherwise. Explicit impls pass through."""
    if attn_impl in ("naive", "chunked", "flash"):
        return attn_impl
    if attn_impl != "auto":
        raise ValueError(
            f"Unknown attention_impl {attn_impl!r}; "
            "expected 'auto', 'naive', 'chunked' or 'flash'."
        )
    if num_tokens <= AUTO_CHUNK_THRESHOLD:
        return "naive"
    if (
        isinstance(batch, int)
        and batch * num_tokens * num_tokens * 4
        <= NAIVE_BWD_RESIDUAL_BUDGET_BYTES
    ):
        return "naive"
    return "chunked"


def resolve_serving_impl(
    attn_impl: str, num_tokens: int, channels: Optional[int] = None
) -> str:
    """The ``auto`` policy for forward-only calls (server, serve CLI): flash
    from :data:`SERVING_FLASH_MIN_TOKENS` up when the kernel takes the shape
    (``flash_attention.eligible``), :func:`resolve_impl` otherwise."""
    if (
        attn_impl == "auto"
        and num_tokens >= SERVING_FLASH_MIN_TOKENS
        and channels is not None
        and flash_attention.eligible(num_tokens, channels)
    ):
        return "flash"
    return resolve_impl(attn_impl, num_tokens, channels)


__all__ = [
    "chunked_attention",
    "naive_attention",
    "resolve_impl",
    "resolve_serving_impl",
]
