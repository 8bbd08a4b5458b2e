"""Logit lens for VAEs: per-channel activation maps and their projection
through a fixed random mini-decoder, drawn with PIL.

Counterpart of ``vae_channel_dynamics_tpu/analysis/logit_lens.py``: the
same mini-decoder ``ConvTranspose(C_in, 16, k3, s2) -> ReLU ->
ConvTranspose(16, 3, k3, s2) -> Sigmoid``, randomly initialised from a seed
and never trained (a fixed random lens by design), the same two projection
modes (``mini_decoder_single_channel``, ``mini_decoder_full_map``), the same
acceptance of the monitor's per-step dicts, and the same directory and file
names, so tooling finds the same artifact tree.

Rendering: the card's machine has no matplotlib, so the images are drawn
with PIL. The numeric part is split from the drawing and is the tested
contract: :func:`normalized_tiles` (per-tile min-max normalisation, the JAX
package's ``imshow`` input), :func:`colorize` (a colormap's table:
viridis, the one the repository's configs name, carried as a constant so
that it needs no matplotlib; any other is matplotlib's own table, and where
matplotlib does not import the call raises an error that names it, never
drawing with another colormap), and the projections. The drawing puts the images side by
side on a white 2-pixel gap; the JAX package's figure chrome (titles, axes,
figure size) is not reproduced.

Activations arrive as NCHW numpy arrays (the capture taps' layout); the
projections come back NHWC in [0, 1], as from the Flax module. The port's
mini-decoder is seeded with ``torch.Generator().manual_seed(seed)``: it need
not equal JAX's draw, and :func:`state_dict_from_flax_params` carries the
Flax parameters across where the two must agree.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger(__name__)

# matplotlib's viridis at its 256 entries, as uint8 RGB
_VIRIDIS_HEX = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
)
VIRIDIS = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), dtype=np.uint8).reshape(256, 3)
COLORMAPS = {"viridis": VIRIDIS}


def _colormap(name: str) -> np.ndarray:
    """The (N, 3) uint8 table of a colormap: the carried viridis, or
    matplotlib's (kept once read)."""
    if name not in COLORMAPS:
        try:
            import matplotlib
        except ImportError as e:
            raise ValueError(
                f"colormap {name!r} needs matplotlib, which is not importable here ({e}); "
                f"the port carries {sorted(COLORMAPS)} without it"
            ) from e
        try:
            cmap = matplotlib.colormaps[name]
        except KeyError as e:
            raise ValueError(f"colormap {name!r} is not one of matplotlib's") from e
        COLORMAPS[name] = cmap(np.arange(cmap.N), bytes=True)[:, :3]
    return COLORMAPS[name]


def normalized_tiles(arr: np.ndarray, sample: int, num_channels: int) -> np.ndarray:
    """(num_channels, H, W) fp32: each channel of ``arr[sample]`` min-max
    normalised to [0, 1] on its own, zero where it is flat (range <= 1e-6)."""
    out = []
    for c in range(num_channels):
        tile = np.asarray(arr[sample, c], dtype=np.float32)
        lo, hi = tile.min(), tile.max()
        out.append((tile - lo) / (hi - lo) if hi - lo > 1e-6 else np.zeros_like(tile))
    return np.stack(out)


def colorize(values: np.ndarray, colormap: str = "viridis") -> np.ndarray:
    """Values in [0, 1] as uint8 RGB (``values.shape + (3,)``) through the
    colormap's N entries (256 for viridis): entry ``min(floor(v * N),
    N - 1)``, matplotlib's lookup."""
    lut = _colormap(colormap)
    n = len(lut)
    idx = np.clip((np.asarray(values, dtype=np.float32) * float(n)).astype(np.int64), 0, n - 1)
    return lut[idx]


def to_uint8(rgb01: np.ndarray) -> np.ndarray:
    """RGB in [0, 1] as uint8, truncated like the JAX package's full-map PNG."""
    return (np.asarray(rgb01) * 255).astype(np.uint8)


def side_by_side(images: List[np.ndarray], gap: int = 2) -> np.ndarray:
    """uint8 HxWx3 images in one row on white, ``gap`` pixels apart and
    around."""
    h = max(im.shape[0] for im in images)
    w = sum(im.shape[1] for im in images) + gap * (len(images) + 1)
    canvas = np.full((h + 2 * gap, w, 3), 255, dtype=np.uint8)
    x = gap
    for im in images:
        canvas[gap:gap + im.shape[0], x:x + im.shape[1]] = im
        x += im.shape[1] + gap
    return canvas


def _save_png(rgb: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(rgb).save(path)


class MiniDecoder(nn.Module):
    """Two stride-2 3x3 transposed convs, C_in -> 16 -> 3, ReLU between,
    Sigmoid after: the Flax ``MiniDecoder`` with ``ConvTranspose(padding=
    "SAME")``. That Flax layer (``transpose_kernel=False``) does not flip its
    kernel and pads asymmetrically: it is a plain cross-correlation over the
    input dilated by 2 (zeros between pixels) and padded by (2, 1) on each
    spatial axis, which gives 2H x 2W. This module computes exactly that.
    NCHW in, NCHW out."""

    def __init__(self, in_channels: int = 1):
        super().__init__()
        self.in_channels = in_channels
        self.conv1 = nn.Conv2d(in_channels, 16, 3)
        self.conv2 = nn.Conv2d(16, 3, 3)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Normal weights of variance 1/fan_in (Flax's lecun_normal scale),
        zero biases."""
        for conv in (self.conv1, self.conv2):
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator)
                              / math.sqrt(fan_in))
            conv.bias.zero_()

    @staticmethod
    def _up(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        n, c, h, w = x.shape
        dil = x.new_zeros((n, c, 2 * h - 1, 2 * w - 1))
        dil[:, :, ::2, ::2] = x
        return conv(F.pad(dil, (2, 1, 2, 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._up(torch.relu(self._up(x, self.conv1)), self.conv2))


def state_dict_from_flax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The Flax mini-decoder's params (``ConvTranspose_0``/``_1``, HWIO
    kernels) as :class:`MiniDecoder`'s state dict (OIHW weights)."""
    out = {}
    for flax_name, name in (("ConvTranspose_0", "conv1"), ("ConvTranspose_1", "conv2")):
        kernel = np.asarray(params[flax_name]["kernel"], dtype=np.float32)
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        out[f"{name}.bias"] = torch.from_numpy(np.array(params[flax_name]["bias"], dtype=np.float32))
    return out


class VAELogitLens:
    def __init__(
        self,
        logit_lens_config: Optional[Dict[str, Any]] = None,
        main_experiment_output_dir: str = "./experiment_outputs",
        seed: int = 0,
        device: Any = "cpu",
    ):
        self.config = logit_lens_config or {}
        self.default_num_channels = self.config.get(
            "default_num_channels_to_viz", self.config.get("num_channels_to_viz", 4))
        self.default_batch_samples = self.config.get(
            "default_num_batch_samples_to_viz",
            self.config.get("num_batch_samples_to_viz", 1),
        )
        self.colormap = self.config.get("colormap", "viridis")
        _colormap(self.colormap)
        viz_subdir = self.config.get("visualization_output_subdir", "logit_lens_visualizations")
        self.visualization_base_dir = os.path.join(main_experiment_output_dir, viz_subdir)
        os.makedirs(self.visualization_base_dir, exist_ok=True)
        self.seed = seed
        self.device = torch.device(device)
        self._decoders: Dict[int, MiniDecoder] = {}
        logger.info("VAELogitLens initialized. Visualizations in: %s",
                    self.visualization_base_dir)

    # ------------------------------------------------------------------ #
    def decoder_for(self, in_channels: int) -> MiniDecoder:
        """The seeded mini-decoder for ``in_channels`` inputs, built once."""
        if in_channels not in self._decoders:
            module = MiniDecoder(in_channels)
            module.init_weights(torch.Generator().manual_seed(self.seed))
            self._decoders[in_channels] = module.to(self.device).eval()
        return self._decoders[in_channels]

    @torch.no_grad()
    def project_through_mini_decoder(self, nchw: np.ndarray) -> np.ndarray:
        """(B, C, H, W) -> (B, 4H, 4W, 3) in [0, 1], NHWC numpy."""
        decoder = self.decoder_for(nchw.shape[1])
        x = torch.as_tensor(np.asarray(nchw, dtype=np.float32), device=self.device)
        return decoder(x).permute(0, 2, 3, 1).cpu().numpy()

    @staticmethod
    def _safe_name(layer_identifier: str) -> str:
        return layer_identifier.replace(".", "_").replace("/", "_")

    def get_layer_logit_length(self, activation_map: np.ndarray,
                               layer_identifier: str) -> Optional[int]:
        if np.ndim(activation_map) != 4:
            logger.warning("Cannot compute logit length for %s: not a 4D tensor",
                           layer_identifier)
            return None
        n = int(activation_map.shape[1])
        logger.info("Logit length (channels) for '%s': %d", layer_identifier, n)
        return n

    # ------------------------------------------------------------------ #
    def visualize_channel_activation_maps(
        self,
        activation_map_tensor: np.ndarray,
        layer_identifier: str,
        global_step: int,
        num_channels_to_viz: Optional[int] = None,
        num_batch_samples_to_viz: Optional[int] = None,
        colormap: Optional[str] = None,
    ) -> None:
        """Per-channel maps with per-tile min-max normalisation, saved to
        ``step_{g}/{safe_layer}/sample_{i}_all_channels.png``."""
        arr = np.asarray(activation_map_tensor)
        if arr.ndim != 4:
            logger.warning("Activation map for %s is not 4D (shape %s); skipping.",
                           layer_identifier, getattr(arr, "shape", None))
            return
        n_ch = min(num_channels_to_viz or self.default_num_channels, arr.shape[1])
        n_samples = min(num_batch_samples_to_viz or self.default_batch_samples, arr.shape[0])
        self.get_layer_logit_length(arr, layer_identifier)
        outdir = os.path.join(self.visualization_base_dir, f"step_{global_step}",
                              self._safe_name(layer_identifier))
        os.makedirs(outdir, exist_ok=True)
        cmap = colormap or self.colormap
        for s in range(n_samples):
            tiles = colorize(normalized_tiles(arr, s, n_ch), cmap)
            _save_png(side_by_side(list(tiles)),
                      os.path.join(outdir, f"sample_{s}_all_channels.png"))
            logger.info("Saved activation grid for %s sample %d", layer_identifier, s)

    # ------------------------------------------------------------------ #
    def _resolve_activation(self, layer_name: str,
                            activations: Dict[str, Any]) -> Optional[np.ndarray]:
        """Raw arrays keyed by layer name, or the monitor's per-step metric
        dicts (``<id>.full_activation_map`` names resolve to the map)."""
        value = activations.get(layer_name)
        if value is None and layer_name.endswith(".full_activation_map"):
            value = activations.get(layer_name[: -len(".full_activation_map")])
        if isinstance(value, dict):
            value = value.get("full_activation_map")
        if value is None:
            return None
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        arr = np.asarray(value)
        return arr if arr.ndim == 4 else None

    def single_channel_projections(self, arr: np.ndarray, sample: int) -> np.ndarray:
        """The first channels of ``arr[sample]``, each through the lens as a
        1-channel map: (n_ch, 4H, 4W, 3) in [0, 1]."""
        n_ch = min(self.default_num_channels, arr.shape[1])
        return self.project_through_mini_decoder(arr[sample, :n_ch][:, None])

    def run_logit_lens_with_activations(
        self,
        global_step: int,
        layers_to_analyze: List[str],
        num_batch_samples_to_viz: Optional[int],
        projection_type: str,
        activations_to_process: Dict[str, Any],
    ) -> None:
        n_samples_default = (num_batch_samples_to_viz if num_batch_samples_to_viz is not None
                             else self.default_batch_samples)
        logger.info("--- Running Logit Lens for step %d ---", global_step)
        if not activations_to_process:
            logger.warning("No activations provided. Skipping.")
            return
        for layer_name in layers_to_analyze:
            arr = self._resolve_activation(layer_name, activations_to_process)
            if arr is None:
                logger.warning("No 4D activation for layer '%s'. Skipping.", layer_name)
                continue
            n_samples = min(n_samples_default, arr.shape[0])
            outdir = os.path.join(self.visualization_base_dir, f"step_{global_step}",
                                  self._safe_name(layer_name), "logit_lens_projections")
            os.makedirs(outdir, exist_ok=True)
            logger.info("Logit Lens for '%s' (shape %s)", layer_name, arr.shape)
            for s in range(n_samples):
                if projection_type == "mini_decoder_single_channel":
                    projected = self.single_channel_projections(arr, s)
                    _save_png(side_by_side([to_uint8(p) for p in projected]), os.path.join(
                        outdir, f"lens_sample_{s}_single_channel_projections_combined.png"))
                elif projection_type == "mini_decoder_full_map":
                    projected = self.project_through_mini_decoder(arr[s:s + 1])
                    _save_png(to_uint8(projected[0]),
                              os.path.join(outdir, f"lens_sample_{s}_full_map.png"))
                else:
                    logger.warning("Unknown projection_type: %s. Skipping.", projection_type)
        logger.info("Logit Lens analysis completed for step %d.", global_step)


__all__ = [
    "COLORMAPS",
    "MiniDecoder",
    "VAELogitLens",
    "colorize",
    "normalized_tiles",
    "side_by_side",
    "state_dict_from_flax_params",
    "to_uint8",
]
