from .distributions import DiagonalGaussianDistribution
from .vae import AutoencoderKL, VAEConfig
from .wrapper import SDXLVAEWrapper
