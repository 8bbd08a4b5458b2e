"""vae-channel-dynamics in PyTorch and CUDA, for NVIDIA Hopper GPUs.

The port of the JAX package ``vae_channel_dynamics_tpu`` (the reference it
is tested against), module for module under the same names. Two slices
are ported: the serving path (the SDXL VAE's encode and decode behind the
micro-batching HTTP server and the batch CLI, with the mid block's flash
attention as a hand-written CUDA kernel), and the training step with the
paper's GroupNorm activity taps, the suppressed-channel classifier and the
gamma nudge, with GroupNorm forward and backward as hand-written CUDA
kernels.

Subpackages
-----------
- ``ops``             GroupNorm (plain, or the kernels in
                      ``csrc/group_norm.cu``), the tap statistics, attention
                      (naive, chunked, and the flash kernel in
                      ``csrc/flash_attention_fwd.cu``)
- ``models``          AutoencoderKL with capture taps,
                      DiagonalGaussianDistribution, model-dir I/O, the wrapper
- ``training``        TrainState, the optimizer, the train and eval steps
- ``tracking``        ActivityMonitor, DeadNeuronTracker
- ``classification``  RegionClassifier
- ``intervention``    InterventionHandler
- ``server``          HTTP serving daemon; ``serve`` batch inference CLI

Importing the package never imports jax and never builds a kernel.
"""

__version__ = "0.1.0"
