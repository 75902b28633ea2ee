"""DPFMNet: Siamese DiffusionNet + cross-attention refinement + fmap head.

Port of pose6d_tpu/models/dpfm.py for the default configuration
(input_features="xyz", no gradient features, attention_type="normal",
cross_sampling_ratio=1.0, robust=True: the fmap head takes the refined
features). Batched: every tensor has a leading frame
dimension B where the JAX package vmaps.
"""
from __future__ import annotations

import dataclasses

from torch import nn

from .attention import CrossAttentionRefinementNet
from .diffusion_net import DiffusionNet
from .fmap import solve_fmap


@dataclasses.dataclass(frozen=True)
class DPFMConfig:
    """Model hyperparameters (the JAX package's defaults)."""
    c_in: int = 3
    n_feat: int = 32
    width: int = 64
    n_blocks: int = 2
    n_fmap: int = 30
    k_eig: int = 64     # eigenbasis size of the online operators
    lambda_: float = 100.0
    resolvent_gamma: float = 0.5
    num_heads: int = 2
    gnn_dim: int = 32
    ref_n_layers: int = 1
    overlap_feat_dim: int = 32
    # input normalization (xyz - 110) / 50
    norm_shift: float = 110.0
    norm_scale: float = 50.0


class DPFMNet(nn.Module):
    def __init__(self, cfg: DPFMConfig = DPFMConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = DiffusionNet(
            c_in=cfg.c_in, c_out=cfg.n_feat, width=cfg.width,
            n_blocks=cfg.n_blocks)
        self.feat_refiner = CrossAttentionRefinementNet(
            n_in=cfg.n_feat, num_heads=cfg.num_heads, gnn_dim=cfg.gnn_dim,
            n_layers=cfg.ref_n_layers, overlap_feat_dim=cfg.overlap_feat_dim)

    def _branch(self, shape):
        c = self.cfg
        feats = (shape["xyz"] - c.norm_shift) / c.norm_scale
        return self.feature_extractor(feats, shape["mass"], shape["evals"],
                                      shape["evecs"], shape["valid"])

    def forward(self, cad: dict, pc: dict):
        """cad/pc dicts of padded tensors: xyz (B, V, 3), mass (B, V),
        evals (B, K), evecs (B, V, K), valid (B, V) bool.

        Returns dict: C (B, n_fmap, n_fmap) functional map CAD -> PC,
        overlap12 (B, V1), overlap21 (B, V2), feat1/feat2 (B, V, n_feat)
        the refined features fed to the fmap head.
        """
        c = self.cfg
        feat1 = self._branch(cad)
        feat2 = self._branch(pc)
        ref1, ref2, overlap12, overlap21 = self.feat_refiner(
            feat1, feat2, cad["valid"], pc["valid"])
        k = c.n_fmap
        et1 = cad["evecs"][..., :k].transpose(-1, -2) * cad["mass"][:, None]
        et2 = pc["evecs"][..., :k].transpose(-1, -2) * pc["mass"][:, None]
        C = solve_fmap(ref1, ref2, cad["evals"][:, :k], pc["evals"][:, :k],
                       et1, et2, lambda_=c.lambda_, gamma=c.resolvent_gamma)
        return {"C": C, "overlap12": overlap12, "overlap21": overlap21,
                "feat1": ref1, "feat2": ref2}
