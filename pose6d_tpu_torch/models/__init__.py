from .dpfm import DPFMConfig, DPFMNet
from .weights import load_flax_checkpoint

__all__ = ["DPFMConfig", "DPFMNet", "load_flax_checkpoint"]
