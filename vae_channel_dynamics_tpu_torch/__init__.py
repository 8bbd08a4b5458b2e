"""vae-channel-dynamics in PyTorch and CUDA, for NVIDIA Hopper GPUs.

The port of the JAX package ``vae_channel_dynamics_tpu`` (the reference it
is tested against), module for module under the same names. This first
slice is the serving path: the SDXL VAE's encode and decode behind the
micro-batching HTTP server and the batch CLI, with the mid block's flash
attention as a hand-written CUDA kernel.

Subpackages
-----------
- ``ops``     GroupNorm (plain tensor ops), attention (naive, chunked, and
              the flash kernel in ``csrc/flash_attention_fwd.cu``)
- ``models``  AutoencoderKL, DiagonalGaussianDistribution, model-dir I/O,
              the inference wrapper
- ``server``  HTTP serving daemon; ``serve`` batch inference CLI

Importing the package never imports jax and never builds a kernel.
"""

__version__ = "0.1.0"
