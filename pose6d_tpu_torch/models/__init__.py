from .dpfm import DPFMConfig, DPFMNet
from .weights import init_like_flax, load_flax_checkpoint, save_flax_params

__all__ = ["DPFMConfig", "DPFMNet", "init_like_flax", "load_flax_checkpoint",
           "save_flax_params"]
