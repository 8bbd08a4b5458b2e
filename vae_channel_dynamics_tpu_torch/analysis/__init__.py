from .logit_lens import MiniDecoder, VAELogitLens, state_dict_from_flax_params

__all__ = ["MiniDecoder", "VAELogitLens", "state_dict_from_flax_params"]
