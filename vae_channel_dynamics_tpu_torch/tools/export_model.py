"""Serialize the VAE's inference entry points as ``torch.export`` programs.

The port of ``vae_channel_dynamics_tpu/tools/export_model.py``: each entry
point (deterministic ``encode``, ``decode``, ``reconstruct``) is traced once
by ``torch.export.export(..., strict=False)`` with a **symbolic batch
dimension** (``torch.export.Dim("b")``) and saved by ``torch.export.save``
as ``<name>.pt2``, beside a ``manifest.json`` that describes it.

Parameters are an *argument* of the exported programs, not part of them:
each program is ``forward(params, x)``, which runs the model through
``torch.func.functional_call`` with ``params`` (the model dir's state dict,
keyed as in the model dir) as a pytree input, on a model built on the
``meta`` device and stripped of its parameters. So a ``.pt2`` holds the
graph and no weight, and the weights load from the model dir at the
destination. The programs take the parameters in the dtypes the live
wrapper holds them (conv and linear weights in the compute dtype, GroupNorm
fp32: the manifest's ``param_dtypes``, :func:`cast_params`), so a bf16
program casts no weight a call; and the dtype asserts that ``torch.export``
records at each ``.to()`` are left out of the saved graph (the wrapper
casts its inputs), since they cost host time every call.

Spatial dims stay static, as in JAX; only the batch is symbolic.

Attention is resolved by the serving policy at the export resolution
(``server.resolve_serving_attention_impl``), since the artifacts are what
the server serves: from 4096 mid-block tokens on, where the kernel takes
the shape, the graph calls ``vcd::flash_attention_fwd``
(``ops/flash_attention.py``, a ``torch.library`` custom op), so the
exported program launches the serving flash kernel on the card. GroupNorm
is the plain one, as the server runs it.

Usage:
    python -m vae_channel_dynamics_tpu_torch.tools.export_model \\
        --model_dir results/run/final_model/vae --dst exported/ \\
        [--resolution 256] [--dtype bf16] [--check] [--device cuda]

Loading (e.g. on a serving host):
    from vae_channel_dynamics_tpu_torch.tools.export_model import load_exported
    fns = load_exported("exported/")            # {'encode': f, ...}
    latents = fns["encode"](params, pixels_nhwc)

Unlike a JAX StableHLO artifact, loading needs torch and the port's op
registration (:func:`load_exported` imports ``ops.flash_attention``, which
registers ``vcd::flash_attention_fwd``), though not the model's source; and
an artifact runs on the device type it was exported for (the manifest's
``device``). Sampling-mode encode is not exported: the deterministic path
is the deployment contract. The entry points are the live wrapper's
(``models/wrapper.py``): scaling factor on encode, divide and clamp on
decode, reconstruction from the posterior mode without the clamp.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

logger = logging.getLogger(__name__)

MANIFEST = "manifest.json"
ENTRY_POINTS = ("encode", "decode", "reconstruct")
FORMAT = "torch.export"
# the exported programs' signature: forward(params: dict, x: NHWC tensor)
CALLING_CONVENTION_VERSION = 1
_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


class _Entry(nn.Module):
    """One entry point over NHWC tensors, with the live wrapper's math."""

    def __init__(self, vae: nn.Module, name: str, scaling_factor: float):
        super().__init__()
        self.vae = vae
        self.name = name
        self.scaling_factor = scaling_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..models.distributions import DiagonalGaussianDistribution
        from ..models.wrapper import _nchw, _nhwc

        vae = self.vae
        if self.name == "decode":
            img = _nhwc(vae.decode(_nchw(x / self.scaling_factor)))
            return torch.clamp(img, -1.0, 1.0)
        moments = _nhwc(vae.quant_conv(vae.encoder(_nchw(x))))
        mode = DiagonalGaussianDistribution.from_moments(moments, dim=-1).mode()
        if self.name == "encode":
            return mode * self.scaling_factor
        return _nhwc(vae.decode(_nchw(mode)))


class _Program(nn.Module):
    """``forward(params, x)``: the entry point with ``params`` in place of the
    (stripped) model parameters."""

    def __init__(self, entry: _Entry):
        super().__init__()
        self.entry = entry

    def forward(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        named = {f"vae.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self.entry, named, (x,))


def _stripped_model(config, dtype: torch.dtype, attn_impl: str
                    ) -> Tuple[nn.Module, Dict[str, torch.dtype]]:
    """The model on the ``meta`` device with no parameters left: every
    parameter becomes a plain attribute (None) that ``functional_call``
    fills, so the exported program owns no weight. Also the dtype of each
    parameter as the live wrapper holds it (``cast_compute_dtype_``)."""
    from ..models.vae import AutoencoderKL

    vae = AutoencoderKL(config, attn_impl=attn_impl, device="meta", dtype=dtype)
    vae.cast_compute_dtype_(dtype)
    dtypes = {k: v.dtype for k, v in vae.state_dict().items()}
    for module in vae.modules():
        for name in list(module._parameters):
            del module._parameters[name]
            setattr(module, name, None)
    return vae, dtypes


def _aval(dtype: torch.dtype, shape) -> str:
    return f"{_DTYPE_NAMES.get(dtype, str(dtype))}[{','.join(str(d) for d in shape)}]"


def _drop_bulk(exported) -> None:
    """Leave out of the saved program what running it does not need: the
    example inputs (the params among them) and each node's Python stack
    trace and module path, which would make it large, and the dtype asserts
    of the ``.to()`` calls, which cost host time every call."""
    exported.example_inputs = None
    graph = exported.graph
    for node in list(graph.nodes):
        if node.op == "call_function" and node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
            continue
        for key in ("stack_trace", "nn_module_stack", "source_fn_stack", "torch_fn"):
            node.meta.pop(key, None)
    exported.graph_module.recompile()


def vcd_ops(exported) -> list:
    """The ``vcd::`` custom ops an exported program's graph calls."""
    names = set()
    for node in exported.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("vcd."):
            names.add(str(node.target).split(".")[1])
    return sorted(f"vcd::{n}" for n in names)


def export_model_dir(
    model_dir: str,
    dst: str,
    resolution: int = 256,
    dtype_name: str = "fp32",
    device: Any = "cuda",
) -> Dict[str, Any]:
    """Export all entry points for ``model_dir`` into ``dst``: ``<name>.pt2``
    per entry point and ``manifest.json`` (shapes, dtypes, torch version,
    calling-convention version, device, attention impl and each program's
    ``vcd::`` ops: what a loader checks before it runs one). Returns the
    manifest."""
    from ..models import io as model_io
    from ..models.wrapper import resolve_device
    from ..server import resolve_serving_attention_impl

    config, state_dict = model_io.load_model_dir(model_dir)
    dev = resolve_device(device)
    dtype = _DTYPES[dtype_name]
    res = int(resolution)
    latent_res = res // (2 ** (len(config.block_out_channels) - 1))
    attn_impl = resolve_serving_attention_impl("auto", res, config, logger=logger)
    vae, param_dtypes = _stripped_model(config, dtype, attn_impl)
    params = {k: v.to(dev, param_dtypes[k]) for k, v in state_dict.items()}
    examples = {
        "encode": (2, res, res, config.in_channels),
        "decode": (2, latent_res, latent_res, config.latent_channels),
        "reconstruct": (2, res, res, config.in_channels),
    }
    batch = torch.export.Dim("b", min=1)

    os.makedirs(dst, exist_ok=True)
    manifest: Dict[str, Any] = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "calling_convention_version": CALLING_CONVENTION_VERSION,
        "device": dev.type,
        "resolution": res,
        "latent_resolution": latent_res,
        "latent_channels": config.latent_channels,
        "dtype": _DTYPE_NAMES[dtype],
        "scaling_factor": config.scaling_factor,
        "attention_impl": attn_impl,
        "param_dtypes": {k: _DTYPE_NAMES[v] for k, v in param_dtypes.items()},
        "entry_points": {},
    }
    for name in ENTRY_POINTS:
        program = _Program(_Entry(vae, name, config.scaling_factor))
        x = torch.zeros(examples[name], dtype=dtype, device=dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            exported = torch.export.export(
                program, (params, x),
                dynamic_shapes=({k: None for k in params}, {0: batch}),
                strict=False,
            )
        _drop_bulk(exported)
        fname = f"{name}.pt2"
        path = os.path.join(dst, fname)
        torch.export.save(exported, path)
        seconds = time.perf_counter() - t0
        out = [n for n in exported.graph.nodes if n.op == "output"][0].args[0][0].meta["val"]
        manifest["entry_points"][name] = {
            "file": fname,
            "bytes": os.path.getsize(path),
            "params": len(params),
            "in_avals": [_aval(dtype, ("b",) + examples[name][1:])],
            "out_avals": [_aval(out.dtype, ("b",) + tuple(out.shape[1:]))],
            "vcd_ops": vcd_ops(exported),
            "export_seconds": round(seconds, 3),
        }
        logger.info("Exported %s (%d bytes, %.1f s, ops %s)", name,
                    manifest["entry_points"][name]["bytes"], seconds,
                    manifest["entry_points"][name]["vcd_ops"])
    with open(os.path.join(dst, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def check_loadable(path: str, device: Any = None) -> Dict[str, Any]:
    """The export dir's manifest, after refusing an export for another
    device type than ``device`` (when given) and one whose ``vcd::`` ops are
    not registered, naming them."""
    from ..ops import flash_attention  # noqa: F401 — registers vcd::flash_attention_fwd

    manifest = read_manifest(path)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} export (format {manifest.get('format')!r})")
    if device is not None and torch.device(device).type != manifest["device"]:
        raise ValueError(
            f"{path} was exported for device {manifest['device']!r}; it cannot run on "
            f"{str(device)!r} (export it again with --device {torch.device(device).type})"
        )
    for info in manifest["entry_points"].values():
        missing = [op for op in info["vcd_ops"]
                   if not hasattr(torch.ops.vcd, op.split("::", 1)[1])]
        if missing:
            raise RuntimeError(f"{path}/{info['file']} calls ops that are not registered: "
                               f"{missing}")
    return manifest


def load_program(path: str, manifest: Dict[str, Any], name: str) -> Callable:
    """The saved program of one entry point (``ExportedProgram.module()``)."""
    return torch.export.load(os.path.join(path, manifest["entry_points"][name]["file"])).module()


def cast_params(manifest: Dict[str, Any], params: Mapping[str, torch.Tensor],
                device: Any = None) -> Dict[str, torch.Tensor]:
    """``params`` (a model dir's state dict) in the dtypes the programs take
    (the manifest's ``param_dtypes``), on ``device``."""
    dtypes = {name: _DTYPES["bf16" if dt == "bfloat16" else "fp32"]
              for name, dt in manifest["param_dtypes"].items()}
    return {k: v.to(device, dtypes[k]) for k, v in params.items()}


def load_exported(path: str, device: Any = None) -> Dict[str, Callable]:
    """Load every entry point of an export dir: ``{name: callable(params, x)
    -> y}``, each the saved program, any batch size; ``params`` as
    :func:`cast_params` gives them, ``x`` in the manifest's ``dtype``.
    Refuses what :func:`check_loadable` refuses."""
    manifest = check_loadable(path, device)
    return {name: load_program(path, manifest, name) for name in manifest["entry_points"]}


class ExportedVAEWrapper:
    """Serve the exported programs through the wrapper protocol the serving
    daemon reads (``encode``/``decode``/``forward``, ``device``,
    ``scaling_factor``, ``latent_shape``, ``use_tiling``, ``use_slicing``).

    This is the deployment mode of ``server.py --exported_dir``: the device
    programs are the saved graphs, validated at export time, never traced
    again from the current model code. Deterministic only (the artifacts
    hold no sampling program): ``deterministic=False`` and
    ``sample_posterior=True`` raise ``ValueError``, which the server turns
    into a client error. The params (the model dir's state dict) are cast to
    the programs' dtypes and placed on the device once. The manifest is checked at construction
    (:func:`check_loadable`); each program loads at its entry point's first
    call (the server's warmup calls them all)."""

    use_tiling = False
    use_slicing = False
    # the programs are pinned to the device they load on: served on one card
    supports_mesh = False

    def __init__(self, export_dir: str, params: Mapping[str, torch.Tensor], device: Any = None):
        from ..models.wrapper import resolve_device

        self.export_dir = export_dir
        self.manifest = read_manifest(export_dir)
        self.device = resolve_device(device if device is not None else self.manifest["device"])
        check_loadable(export_dir, self.device)
        self._fns: Dict[str, Callable] = {}
        self._load_lock = threading.Lock()
        self.params = cast_params(self.manifest, params, self.device)
        self.resolution = int(self.manifest["resolution"])
        self.scaling_factor = float(self.manifest["scaling_factor"])
        latent_res = int(self.manifest["latent_resolution"])
        self.latent_shape = (latent_res, latent_res, int(self.manifest["latent_channels"]))
        self.dtype = _DTYPES["bf16" if self.manifest["dtype"] == "bfloat16" else "fp32"]

    def _program(self, name: str) -> Callable:
        """The loaded program of entry point ``name``."""
        with self._load_lock:
            if name not in self._fns:
                self._fns[name] = load_program(self.export_dir, self.manifest, name)
            return self._fns[name]

    def _call(self, name: str, x: Any) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        with torch.inference_mode():
            return self._program(name)(self.params, x)

    @staticmethod
    def _deterministic_only(what: str):
        raise ValueError(
            f"{what} is not available when serving exported artifacts "
            "(deterministic-only); serve the live model for sampling"
        )

    def encode(self, pixel_values: Any, deterministic: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not deterministic:
            self._deterministic_only("posterior sampling (encode)")
        return self._call("encode", pixel_values)

    def decode(self, latents: Any) -> torch.Tensor:
        return self._call("decode", latents)

    def forward(self, pixel_values: Any, sample_posterior: bool = True,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if sample_posterior:
            self._deterministic_only("posterior sampling (reconstruct)")
        return {"reconstruction": self._call("reconstruct", pixel_values)}


def check_export(model_dir: str, dst: str, device: Any = "cuda", batch: int = 2) -> Dict[str, float]:
    """The exported ``reconstruct`` against the live wrapper on a seeded
    uniform batch in [-1, 1] (rounded to the export dtype): ``err``, the max
    abs difference, and ``bound``: 1e-4 at fp32 (with TF32 off), at bf16 the
    live path's own bf16-vs-fp32 difference on the same batch."""
    from ..models import SDXLVAEWrapper
    from ..models import io as model_io

    config, state_dict = model_io.load_model_dir(model_dir)
    manifest = read_manifest(dst)
    exported = ExportedVAEWrapper(dst, state_dict, device)
    res = manifest["resolution"]
    gen = torch.Generator().manual_seed(0)
    x = (torch.rand((batch, res, res, config.in_channels), generator=gen) * 2 - 1)
    x = x.to(exported.dtype).float()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        def live(dtype):
            wrapper = SDXLVAEWrapper(config=config, state_dict=state_dict, dtype=dtype,
                                     attn_impl=manifest["attention_impl"], device=exported.device)
            return wrapper.forward(x, sample_posterior=False)["reconstruction"].float()

        want = live(exported.dtype)
        got = exported.forward(x, sample_posterior=False)["reconstruction"].float()
        bound = 1e-4
        if exported.dtype == torch.bfloat16:
            bound = float((want - live(torch.float32)).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return {"err": float((got - want).abs().max()), "bound": bound}


def main(argv=None) -> int:
    from ..utils.logging_utils import setup_logging

    setup_logging()
    parser = argparse.ArgumentParser(
        description="Export VAE inference entry points as torch.export programs "
        "(symbolic batch; the weights stay in the model dir)."
    )
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--dst", required=True)
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--dtype", default="fp32", choices=sorted(_DTYPES))
    parser.add_argument("--device", default="cuda",
                        help="Device the programs are exported for and run on; 'cuda' "
                        "fails when no GPU is visible (pass 'cpu' to run on the CPU).")
    parser.add_argument(
        "--check",
        action="store_true",
        help="after exporting, load the programs and compare a reconstruct() "
        "against the live model on a small random batch",
    )
    args = parser.parse_args(argv)
    manifest = export_model_dir(args.model_dir, args.dst, args.resolution, args.dtype,
                                args.device)
    logger.info("Export complete: %s -> %s (%s)", args.model_dir, args.dst,
                ", ".join(manifest["entry_points"]))
    if args.check:
        result = check_export(args.model_dir, args.dst, args.device)
        logger.info("check: max |exported - live| = %.3g (bound %.3g)", result["err"],
                    result["bound"])
        if not result["err"] <= result["bound"]:
            raise SystemExit(f"export check failed: max abs err {result['err']} > "
                             f"{result['bound']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
