"""The input pipeline: the port's own copy of ``vae_channel_dynamics_tpu.data``
(sources, transform, loader, prefetcher) and its synthetic datasets."""

from .pipeline import (
    Prefetcher,
    create_dataloader,
    get_transform,
    load_and_preprocess_dataset,
)
from .synthetic import SyntheticImageDataset
