from .group_norm import group_norm
