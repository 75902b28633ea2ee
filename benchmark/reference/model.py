"""Plain DPFM forward (Attaiki et al., 3DV 2021) as the configurations
state it, on the flax params tree of a weights file: DiffusionNet
(first_lin, blocks of learned-time spectral heat diffusion + a 3-layer
MLP + skip, last_lin; padded rows re-zeroed), the cross-attention
refiner (one shared attentional-propagation layer, x updated first, then
y from the updated x; masked instance norm in its MLP; channel split
(dim, heads), dim-major), the overlap head, and the regularized
functional-map solve with the resolvent mask. Input channels: xyz
normalized as (xyz - 110) / 50, and with "hks" the heat kernel
signature at n_hks log-spaced times in [4 ln10 / lambda_max, 4 ln10 /
lambda_2] (torch.linspace, not the rounding of any particular
compiler), each channel scaled to mass-weighted mean 1.

Written from the published description and the configuration alone: it
imports nothing of the program. Batched over a leading B.
"""
from __future__ import annotations

import math

import torch

from .precision import Prec


def params_to(tree: dict, prec: Prec, device):
    """The params tree as tensors of the reference's dtype on `device`."""
    return {k: (params_to(v, prec, device) if isinstance(v, dict)
                else torch.tensor(v).to(device=device, dtype=prec.dtype))
            for k, v in tree.items()}


def _dense(p, x, prec):
    return prec.mm(x, p["kernel"]) + p["bias"]


def _masked_mean(x, w, dim):
    return (x * w).sum(dim) / (w.sum(dim) + 1e-12)


def hks(evals, evecs, mass, valid, n_t: int):
    lam = torch.clamp(evals, min=0.0)
    l_lo = torch.clamp(lam[:, 1], min=1e-6)
    l_hi = torch.maximum(lam[:, -1], l_lo * 1.01)
    c = 4.0 * math.log(10.0)
    lo, hi = torch.log(c / l_hi), torch.log(c / l_lo)
    frac = torch.linspace(0.0, 1.0, n_t, dtype=evals.dtype,
                          device=evals.device)
    t = torch.exp(lo[:, None] + (hi - lo)[:, None] * frac)       # (B, T)
    e = torch.exp(-lam[:, None, :] * t[:, :, None])            # (B, T, K)
    h = (evecs * evecs) @ e.transpose(-1, -2)                  # (B, V, T)
    w = (mass * valid)[..., None]
    mean = (w * h).sum(1) / torch.clamp(w.sum(1), min=1e-12)
    h = h / torch.clamp(mean, min=1e-12)[:, None, :]
    return h * valid[..., None]


def _diffusion_net(p, x, shape, prec):
    valid = shape["valid"][..., None].to(x.dtype)
    evecs, mass, evals = shape["evecs"], shape["mass"], shape["evals"]
    x = _dense(p["first_lin"], x, prec) * valid
    b = 0
    while f"block_{b}" in p:
        blk = p[f"block_{b}"]
        spec = prec.mm(evecs.transpose(-1, -2), x * mass[..., None])
        coefs = torch.exp(-evals[..., None]
                          * torch.clamp(blk["diffusion_time"], min=1e-8))
        diffused = prec.mm(evecs, spec * coefs)
        h = torch.cat([x, diffused], dim=-1)
        mlp = blk["mlp"]
        n = len(mlp)
        for i in range(n):
            h = _dense(mlp[f"layer_{i:03d}"], h, prec)
            if i + 1 < n:
                h = torch.relu(h)
        x = (h + x) * valid
        b += 1
    return _dense(p["last_lin"], x, prec) * valid


def _instance_norm(x, valid):
    w = valid[..., None].to(x.dtype)
    mu = _masked_mean(x, w, -2)[..., None, :]
    var = _masked_mean((x - mu) ** 2, w, -2)[..., None, :]
    return (x - mu) / torch.sqrt(var + 1e-5)


def _attention(p, x, src, x_valid, src_valid, heads, prec):
    b, n, d_model = x.shape
    m = src.shape[1]
    dim = d_model // heads

    def split(t, rows):          # channel c = d * heads + h
        return t.reshape(b, rows, dim, heads).permute(0, 3, 1, 2)

    q = split(_dense(p["proj_q"], x, prec), n)
    k = split(_dense(p["proj_k"], src, prec), m)
    v = split(_dense(p["proj_v"], src, prec), m)
    scores = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(dim)  # (b,h,n,m)
    scores = scores.masked_fill(~src_valid[:, None, None, :], -math.inf)
    prob = torch.softmax(scores, dim=-1)
    out = prec.mm(prob, v).permute(0, 2, 3, 1).reshape(b, n, d_model)
    return _dense(p["merge"], out, prec) * x_valid[..., None]


def _propagate(p, x, src, x_valid, src_valid, heads, prec):
    msg = _attention(p["attn"], x, src, x_valid, src_valid, heads, prec)
    h = _dense(p["mlp"]["lin_0"], torch.cat([x, msg], dim=-1), prec)
    h = torch.relu(_instance_norm(h, x_valid))
    return _dense(p["mlp"]["lin_1"], h, prec)


def _overlap(p, f, valid, prec):
    f = f * torch.rsqrt((f * f).sum(-1, keepdim=True) + 1e-12)
    h = torch.relu(_dense(p["lin0"], f, prec))
    return torch.sigmoid(_dense(p["lin1"], h, prec))[..., 0] * valid


def _resolvent(evals_x, evals_y, gamma):
    scale = torch.maximum(evals_x.amax(-1), evals_y.amax(-1))[..., None]
    gx = ((evals_x / scale) ** gamma)[..., None, :]
    gy = ((evals_y / scale) ** gamma)[..., :, None]
    re = gy / (gy ** 2 + 1) - gx / (gx ** 2 + 1)
    im = 1 / (gy ** 2 + 1) - 1 / (gx ** 2 + 1)
    return re ** 2 + im ** 2


def fmap(feat_x, feat_y, cad, pc, n_fmap, lam, gamma, prec):
    """C (B, n_fmap, n_fmap), CAD -> PC: row i solves (A A^T + lam
    diag(D_i)) c_i = (B A^T)_i with A = Phi_x^T M_x F_x, B likewise."""
    k = n_fmap
    et_x = cad["evecs"][..., :k].transpose(-1, -2) * cad["mass"][:, None]
    et_y = pc["evecs"][..., :k].transpose(-1, -2) * pc["mass"][:, None]
    A = prec.mm(et_x, feat_x)
    Bm = prec.mm(et_y, feat_y)
    D = _resolvent(cad["evals"][:, :k], pc["evals"][:, :k], gamma)
    AAt = prec.mm(A, A.transpose(-1, -2))
    BAt = prec.mm(Bm, A.transpose(-1, -2))
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    M = AAt[:, None] + lam * D[..., None] * eye
    return torch.linalg.solve(M, BAt[..., None])[..., 0]


def forward(params: dict, model_cfg: dict, cad: dict, pc: dict, prec: Prec):
    """params: the tree of params_to; model_cfg: the configuration's model
    block; cad / pc: dicts of (B, ...) tensors xyz, mass, evals, evecs,
    valid in the reference's dtype. Returns C, overlap12, overlap21, feat1,
    feat2 (the features the fmap head reads)."""
    fm, at = model_cfg["fmap"], model_cfg["attention"]
    if (int(at.get("ref_n_layers", 1)) != 1
            or at.get("attention_type", "normal") != "normal"
            or float(at.get("cross_sampling_ratio", 1.0)) != 1.0
            or fm.get("with_gradient_features", False)
            or int(fm.get("n_blocks", 2)) != 2):
        raise ValueError("the reference covers one refiner layer of normal, "
                         "unsampled attention without gradient features")
    feats = fm.get("input_features", "xyz")

    def branch(s):
        parts = []
        if "xyz" in feats:
            parts.append((s["xyz"] - 110.0) / 50.0)
        if "hks" in feats:
            parts.append(hks(s["evals"], s["evecs"], s["mass"],
                             s["valid"].to(s["xyz"].dtype),
                             int(fm.get("n_hks", 16))))
        return _diffusion_net(params["feature_extractor"],
                              torch.cat(parts, dim=-1), s, prec)

    f1, f2 = branch(cad), branch(pc)
    r = params["feat_refiner"]
    heads = int(at["num_head"])
    v1, v2 = cad["valid"], pc["valid"]
    d0 = _dense(r["first_lin"], f1, prec)
    d1 = _dense(r["first_lin"], f2, prec)
    layer = r["layer_0"]
    d0 = d0 + _propagate(layer, d0, d1, v1, v2, heads, prec)
    d1 = d1 + _propagate(layer, d1, d0, v2, v1, heads, prec)
    ref1 = _dense(r["last_lin"], d0, prec) * v1[..., None]
    ref2 = _dense(r["last_lin"], d1, prec) * v2[..., None]
    ov1 = _overlap(r["overlap"], ref1, v1, prec)
    ov2 = _overlap(r["overlap"], ref2, v2, prec)
    use1, use2 = (ref1, ref2) if fm.get("robust", True) else (f1, f2)
    C = fmap(use1, use2, cad, pc, int(fm["n_fmap"]), float(fm["lambda_"]),
             float(fm["resolvant_gamma"]), prec)
    return {"C": C, "overlap12": ov1, "overlap21": ov2, "feat1": use1,
            "feat2": use2}
