"""DPFMNet: Siamese DiffusionNet + cross-attention refinement + fmap head.

Port of pose6d_tpu/models/dpfm.py with every variant of its
configuration: the encoder's input channels (input_features, any
underscore-joined combination of xyz, hks and wks, in that channel
order), width and depth, tangent-gradient features, the refiner's
attention_type and cross-attention subsampling, and robust=False (the
fmap head on the encoder's features). Batched: every tensor has a
leading frame dimension B where the JAX package vmaps.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.hks import heat_kernel_signature, wave_kernel_signature
from ..ops.sampling import farthest_point_sample, knn
from ..utils.profiling import spanned
from .attention import CrossAttentionRefinementNet
from .diffusion_net import DiffusionNet
from .fmap import solve_fmap


@dataclasses.dataclass(frozen=True)
class DPFMConfig:
    """Model hyperparameters (the JAX package's defaults)."""
    c_in: int = 3       # informational: first_lin's width follows input_features
    n_feat: int = 32
    width: int = 64
    n_blocks: int = 2
    n_fmap: int = 30
    k_eig: int = 64     # eigenbasis size of the online operators
    lambda_: float = 100.0
    resolvent_gamma: float = 0.5
    robust: bool = True
    num_heads: int = 2
    gnn_dim: int = 32
    ref_n_layers: int = 1
    overlap_feat_dim: int = 32
    # input normalization (xyz - 110) / 50
    norm_shift: float = 110.0
    norm_scale: float = 50.0
    # encoder input channels, in the order xyz -> hks -> wks
    input_features: str = "xyz"
    n_hks: int = 16
    n_wks: int = 16
    # tangent-gradient features in DiffusionNet (the shapes then carry
    # grad_idx / grad_cx / grad_cy)
    with_gradient_features: bool = False
    with_gradient_rotations: bool = True
    # "normal" or "double"; < 1: the CAD side attends on an FPS subsample
    attention_type: str = "normal"
    cross_sampling_ratio: float = 1.0

    @property
    def input_width(self) -> int:
        """first_lin's input rows: 3 [xyz] + n_hks [hks] + n_wks [wks]."""
        f = self.input_features
        return (3 * ("xyz" in f) + self.n_hks * ("hks" in f)
                + self.n_wks * ("wks" in f))

    @classmethod
    def from_yaml_dict(cls, cfg: dict) -> "DPFMConfig":
        """Build from the parsed `model` block of a config/*.yaml file
        (fmap / attention / overlap). `use_flash` is accepted and
        ignored: on the card the hand-written kernel is the only
        attention route."""
        f, a, o = cfg["fmap"], cfg["attention"], cfg["overlap"]
        return cls(
            c_in=f["C_in"], n_feat=f["n_feat"], n_fmap=f["n_fmap"],
            width=int(f.get("width", 64)),
            n_blocks=int(f.get("n_blocks", 2)),
            k_eig=f["k_eig"], lambda_=float(f["lambda_"]),
            resolvent_gamma=float(f["resolvant_gamma"]), robust=f["robust"],
            num_heads=a["num_head"], gnn_dim=a["gnn_dim"],
            ref_n_layers=a["ref_n_layers"],
            overlap_feat_dim=o["overlap_feat_dim"],
            attention_type=a.get("attention_type", "normal"),
            cross_sampling_ratio=float(a.get("cross_sampling_ratio", 1.0)),
            with_gradient_features=bool(
                f.get("with_gradient_features", False)),
            with_gradient_rotations=bool(
                f.get("with_gradient_rotations", True)),
            input_features=str(f.get("input_features", "xyz")),
            n_hks=int(f.get("n_hks", 16)),
            n_wks=int(f.get("n_wks", 16)))


class DPFMNet(nn.Module):
    def __init__(self, cfg: DPFMConfig = DPFMConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = DiffusionNet(
            c_in=cfg.input_width, c_out=cfg.n_feat, width=cfg.width,
            n_blocks=cfg.n_blocks,
            with_gradient_features=cfg.with_gradient_features,
            with_gradient_rotations=cfg.with_gradient_rotations)
        self.feat_refiner = CrossAttentionRefinementNet(
            n_in=cfg.n_feat, num_heads=cfg.num_heads, gnn_dim=cfg.gnn_dim,
            n_layers=cfg.ref_n_layers, overlap_feat_dim=cfg.overlap_feat_dim,
            attention_type=cfg.attention_type,
            cross_sampling_ratio=cfg.cross_sampling_ratio)

    def branch(self, shape):
        """One shape's encoder features: its input channels (xyz, hks,
        wks, in that order) through the shared DiffusionNet."""
        c = self.cfg
        parts = []
        if "xyz" in c.input_features:
            parts.append((shape["xyz"] - c.norm_shift) / c.norm_scale)
        if "hks" in c.input_features:
            parts.append(heat_kernel_signature(
                shape["evals"], shape["evecs"], shape["mass"],
                shape["valid"], n_t=c.n_hks))
        if "wks" in c.input_features:
            parts.append(wave_kernel_signature(
                shape["evals"], shape["evecs"], shape["mass"],
                shape["valid"], n_e=c.n_wks))
        grad = None
        if c.with_gradient_features and "grad_idx" in shape:
            grad = (shape["grad_idx"], shape["grad_cx"], shape["grad_cy"])
        return self.feature_extractor(torch.cat(parts, dim=-1),
                                      shape["mass"], shape["evals"],
                                      shape["evecs"], shape["valid"], grad)

    @spanned("model")
    def forward(self, cad: dict, pc: dict):
        """cad/pc dicts of padded tensors: xyz (B, V, 3), mass (B, V),
        evals (B, K), evecs (B, V, K), valid (B, V) bool, and with
        gradient features grad_idx (B, V, Kn) int, grad_cx / grad_cy (B,
        V, Kn).

        Returns dict: C (B, n_fmap, n_fmap) functional map CAD -> PC,
        overlap12 (B, V1), overlap21 (B, V2), feat1/feat2 (B, V, n_feat)
        the features fed to the fmap head, ref_feat1/ref_feat2 the
        refined features.
        """
        c = self.cfg
        feat1 = self.branch(cad)
        feat2 = self.branch(pc)
        x_samples = None
        if c.cross_sampling_ratio < 1.0:
            # the sample count follows the padded width, not the valid count
            n_s = max(int(c.cross_sampling_ratio * feat1.shape[1]), 8)
            idf, s_valid = farthest_point_sample(cad["xyz"], cad["valid"],
                                                 n_s)
            sampled = torch.gather(cad["xyz"], 1,
                                   idf[..., None].expand(-1, -1, 3))
            dists, idn = knn(cad["xyz"], cad["valid"], sampled, s_valid, k=3)
            x_samples = (idf, idn, dists)
        ref1, ref2, overlap12, overlap21 = self.feat_refiner(
            feat1, feat2, cad["valid"], pc["valid"], x_samples)
        use1, use2 = (ref1, ref2) if c.robust else (feat1, feat2)
        k = c.n_fmap
        et1 = cad["evecs"][..., :k].transpose(-1, -2) * cad["mass"][:, None]
        et2 = pc["evecs"][..., :k].transpose(-1, -2) * pc["mass"][:, None]
        C = solve_fmap(use1, use2, cad["evals"][:, :k], pc["evals"][:, :k],
                       et1, et2, lambda_=c.lambda_, gamma=c.resolvent_gamma)
        return {"C": C, "overlap12": overlap12, "overlap21": overlap21,
                "feat1": use1, "feat2": use2,
                "ref_feat1": ref1, "ref_feat2": ref2}
