"""Model directory save/load, a small safetensors reader/writer, and the
conversion from the JAX package's parameters.

Counterpart of ``vae_channel_dynamics_tpu/models/io.py``. A model directory
is ``config.json`` (the diffusers ``AutoencoderKL`` constructor schema) plus
``diffusion_pytorch_model.safetensors`` with torch parameter names and
layouts, so a directory written by either package loads in the other.

The safetensors format is read and written here on numpy alone, since the
``safetensors`` package is not promised where the port runs: an 8-byte
little-endian header length, a JSON header mapping each name to its dtype,
shape and byte range, then the raw little-endian buffers.

:func:`tensor_blocks` cuts a whole state dict to a tensor rank's channel
blocks (``parallel.tensor``; ``AutoencoderKL.shard_tensor_`` cuts the
model's parameters with it), so weights from either package enter a
tensor rank; ``parallel/zero.py::replicate_leaf`` gathers a block whole
again.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from .vae import VAEConfig

# canonical (diffusers) weight filename first; the JAX package's legacy name
# second, so its older run dirs load too
_SAFETENSORS_NAMES = (
    "diffusion_pytorch_model.safetensors",
    "model.safetensors",
)
_CONFIG_NAME = "config.json"

_DTYPES = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
}
_CODES = {dt: code for code, dt in _DTYPES.items()}


# --------------------------------------------------------------------------- #
# safetensors on numpy
# --------------------------------------------------------------------------- #
def save_safetensors(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write ``{name: array}`` as a safetensors file (names in sorted order,
    header padded with spaces to 8 bytes, as the reference writer does)."""
    header: Dict[str, Any] = {}
    arrays = []
    offset = 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        le = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
        if le not in _CODES:
            raise TypeError(f"{name}: dtype {arr.dtype} has no safetensors code")
        arr = arr.astype(le, copy=False)
        header[name] = {
            "dtype": _CODES[le],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + arr.nbytes],
        }
        offset += arr.nbytes
        arrays.append(arr)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * ((-len(blob)) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in arrays:
            f.write(arr.tobytes())
    os.replace(tmp, path)


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a safetensors file into ``{name: array}``. BF16 tensors are
    widened to float32 (numpy has no bfloat16)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[base + begin:base + end]
        shape = tuple(info["shape"])
        code = info["dtype"]
        if code == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif code in _DTYPES:
            arr = np.frombuffer(raw, dtype=_DTYPES[code])
        else:
            raise TypeError(f"{name}: unsupported safetensors dtype {code}")
        out[name] = arr.reshape(shape).copy()
    return out


# --------------------------------------------------------------------------- #
# model directories
# --------------------------------------------------------------------------- #
def diffusers_config_dict(config: VAEConfig) -> Dict[str, Any]:
    """The diffusers ``AutoencoderKL`` constructor schema for ``config``
    (the JAX package writes the same dict)."""
    n = len(config.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "act_fn": "silu",
        "block_out_channels": list(config.block_out_channels),
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "up_block_types": ["UpDecoderBlock2D"] * n,
        "in_channels": config.in_channels,
        "out_channels": config.out_channels,
        "latent_channels": config.latent_channels,
        "layers_per_block": config.layers_per_block,
        "norm_num_groups": config.norm_num_groups,
        "sample_size": config.sample_size,
        "scaling_factor": config.scaling_factor,
        # diffusers spells the toggle mid_block_add_attention; both keys are
        # written so either reader sees its own. norm_eps is ours alone.
        "mid_block_add_attention": config.mid_block_attention,
        "mid_block_attention": config.mid_block_attention,
        "norm_eps": config.norm_eps,
    }


def save_model_dir(
    path: str, config: VAEConfig, state_dict: Mapping[str, Any]
) -> None:
    """Write a diffusers-compatible model directory: fp32 weights under
    their torch names, and the constructor config."""
    os.makedirs(path, exist_ok=True)
    tensors = {}
    for name, value in state_dict.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().to("cpu", torch.float32).numpy()
        tensors[name] = np.asarray(value, dtype=np.float32)
    save_safetensors(tensors, os.path.join(path, _SAFETENSORS_NAMES[0]))
    # a reused dir must not keep a stale legacy-named weight file beside the
    # canonical one
    for legacy in _SAFETENSORS_NAMES[1:]:
        legacy_path = os.path.join(path, legacy)
        if os.path.exists(legacy_path):
            os.remove(legacy_path)
    cfg = diffusers_config_dict(config)
    cfg["_framework"] = "vae_channel_dynamics_tpu_torch"
    with open(os.path.join(path, _CONFIG_NAME), "w") as f:
        json.dump(cfg, f, indent=2)


def load_model_dir(path: str) -> Tuple[VAEConfig, Dict[str, torch.Tensor]]:
    """Load a model dir written by either package's ``save_model_dir`` (or a
    diffusers AutoencoderKL directory with safetensors weights): the config
    and a CPU state dict of torch tensors."""
    with open(os.path.join(path, _CONFIG_NAME)) as f:
        config = VAEConfig.from_dict(json.load(f))
    for name in _SAFETENSORS_NAMES:
        cand = os.path.join(path, name)
        if os.path.exists(cand):
            arrays = load_safetensors(cand)
            return config, {k: torch.from_numpy(v) for k, v in arrays.items()}
    raise FileNotFoundError(
        f"No safetensors weights in {path} (looked for {_SAFETENSORS_NAMES})"
    )


# --------------------------------------------------------------------------- #
# JAX parameters -> torch state dict
# --------------------------------------------------------------------------- #
# list-valued containers whose Flax child names carry a "_<index>" suffix
_LISTISH = (
    "down_blocks", "up_blocks", "resnets", "attentions", "downsamplers",
    "upsamplers", "to_out",
)


def _torch_module_name(path: Tuple[str, ...]) -> str:
    """``("encoder", "down_blocks_0", "resnets_1")`` ->
    ``encoder.down_blocks.0.resnets.1`` (the JAX package's
    ``utils.naming.path_to_torch_name``)."""
    out = []
    for comp in path:
        head, sep, tail = comp.rpartition("_")
        if sep and tail.isdigit() and head in _LISTISH:
            out.extend((head, tail))
        else:
            out.append(comp)
    return ".".join(out)


def _iter_leaves(
    tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, child in tree.items():
        if isinstance(child, Mapping):
            yield from _iter_leaves(child, prefix + (key,))
        else:
            yield prefix + (key,), child


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax params (nested dicts of arrays) as this
    package's state dict: ``kernel``/``scale`` leaves become ``weight``, conv
    kernels HWIO -> OIHW and dense kernels (in, out) -> (out, in)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _iter_leaves(params):
        *mod_path, leaf_name = path
        arr = np.asarray(leaf)
        if leaf_name == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
        torch_leaf = "weight" if leaf_name in ("kernel", "scale") else leaf_name
        name = f"{_torch_module_name(tuple(mod_path))}.{torch_leaf}"
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out


def tensor_blocks(state_dict: Mapping[str, torch.Tensor], index: int,
                  size: int) -> Dict[str, torch.Tensor]:
    """Tensor rank ``index``'s block of every parameter of a whole state
    dict over ``size`` ranks: each cut along the axis JAX ``_channel_axis``
    picks on its JAX layout (``parallel.zero.tensor_axis``), a parameter no
    axis of which ``size`` divides kept whole."""
    from ..parallel.zero import local_chunk, tensor_axis

    return {k: local_chunk(v, tensor_axis(tuple(v.shape), size), index, size).contiguous()
            for k, v in state_dict.items()}

