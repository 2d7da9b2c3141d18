"""Plain float32 reference of a Mamba-2 language model (the SSD mixer,
arXiv:2405.21060): per layer an RMS norm and the mixer with its residual;
the mixer projects z, x, B, C and dt, runs x, B and C through depthwise
causal convolutions and SiLU, scans with the chunked state-space duality
algorithm (the paper's minimal listing: quadratic inside a chunk, a
recurrence over chunk states), adds D x, gates with SiLU(z) inside an RMS
norm and projects out. Tied embeddings. Read from the configuration's
published keys; the parameter tree uses the program's leaf names. The
port's mixer has no conv bias, and this reference has none either."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import common as C

BLOCK = ("blocks", "p0_ssm")


def sizes(cfg: dict) -> dict:
    s = cfg["ssm_cfg"]
    d = cfg["d_model"]
    di = s["expand"] * d
    m = cfg.get("pad_vocab_size_multiple", 1)
    V = -(-cfg["vocab_size"] // m) * m
    return {"d": d, "L": cfg["n_layer"], "V": V, "di": di,
            "H": di // s["headdim"], "P": s["headdim"], "N": s["d_state"],
            "G": s["ngroups"], "W": s["d_conv"], "Q": s["chunk_size"],
            "eps": cfg["norm_epsilon"]}


def layout(cfg: dict) -> dict:
    """{path: leaf spec} of every parameter."""
    z = sizes(cfg)
    d, L, di, H, GN, W = z["d"], z["L"], z["di"], z["H"], z["G"] * z["N"], \
        z["W"]
    leaves = {
        "w_z": C.spec((d, di)), "w_x": C.spec((d, di)),
        "w_B": C.spec((d, GN)), "w_C": C.spec((d, GN)),
        "w_dt": C.spec((d, H)), "w_out": C.spec((di, d)),
        "conv_x": C.spec((di, W), scale=0.5),
        "conv_B": C.spec((GN, W), scale=0.5),
        "conv_C": C.spec((GN, W), scale=0.5),
        "A_log": C.spec((H,), "float32", "zeros"),
        "D": C.spec((H,), "float32", "ones"),
        "dt_bias": C.spec((H,), "float32", "zeros"),
        "norm": C.spec((di,), init="ones"),
    }
    out = {("embed",): C.spec((z["V"], d), scale=0.02),
           ("ln_f", "scale"): C.spec((d,), init="ones"),
           BLOCK + ("ln1", "scale"): C.stacked(L, C.spec((d,), init="ones"))}
    for n, leaf in leaves.items():
        out[BLOCK + ("ssm", n)] = C.stacked(L, leaf)
    return out


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of x (B, S, C) with w (C, W): output t
    sums w[:, i] * x[t - W + 1 + i]."""
    W = w.shape[1]
    y = F.conv1d(F.pad(x.transpose(1, 2), (W - 1, 0)), w[:, None, :],
                 groups=w.shape[0])
    return y.transpose(1, 2)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): entry (i, j) is x[j+1] + ... + x[i] for
    j <= i, else -inf."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    low = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    s = torch.cumsum(x.masked_fill(~low, 0.0), dim=-2)
    return s.masked_fill(~torch.ones_like(low).tril(), float("-inf"))


def ssd(X, A, Bm, Cm, Q: int):
    """The chunked SSD scan from a zero state. X (b, l, h, p) inputs
    scaled by dt, A (b, l, h) log decays, Bm and Cm (b, l, g, n); l a
    multiple of Q. Returns Y (b, l, h, p)."""
    b, l, h, p = X.shape
    g = Bm.shape[2]
    c = l // Q
    X = X.reshape(b, c, Q, h, p)
    A = A.reshape(b, c, Q, h).permute(0, 3, 1, 2)              # (b,h,c,Q)
    Bh = Bm.reshape(b, c, Q, g, -1).repeat_interleave(h // g, dim=3)
    Ch = Cm.reshape(b, c, Q, g, -1).repeat_interleave(h // g, dim=3)
    Acs = torch.cumsum(A, dim=-1)
    # inside each chunk
    Lm = torch.exp(segsum(A)).permute(0, 2, 1, 3, 4)           # (b,c,h,l,s)
    CB = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)
    Y_diag = torch.einsum("bchls,bcshp->bclhp", CB * Lm, X)
    # each chunk's final state, then the states entering each chunk
    decay = torch.exp(Acs[..., -1:] - Acs).permute(0, 2, 3, 1)  # (b,c,l,h)
    states = torch.einsum("bclhn,bclhp->bchpn", Bh, X * decay[..., None])
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(Acs[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    # the entering states' share of each output
    out_decay = torch.exp(Acs).permute(0, 2, 3, 1)             # (b,c,l,h)
    Y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, states) \
        * out_decay[..., None]
    return (Y_diag + Y_off).reshape(b, l, h, p)


def _layer(h, w, z, mm):
    B, S, _ = h.shape
    H, P, G, N = z["H"], z["P"], z["G"], z["N"]
    u = C.rmsnorm(h, w["ln1"], z["eps"])
    zg = mm(u, w["w_z"])
    x = F.silu(_conv(mm(u, w["w_x"]), w["conv_x"]))
    Bm = F.silu(_conv(mm(u, w["w_B"]), w["conv_B"])).reshape(B, S, G, N)
    Cm = F.silu(_conv(mm(u, w["w_C"]), w["conv_C"])).reshape(B, S, G, N)
    dt = F.softplus(mm(u, w["w_dt"]) + w["dt_bias"])            # (B,S,H)
    A = -torch.exp(w["A_log"])
    xh = x.reshape(B, S, H, P)
    pad = (-S) % z["Q"]
    X, Av, Bp, Cp = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                     for t in (xh * dt[..., None], dt * A, Bm, Cm))
    y = ssd(X, Av, Bp, Cp, z["Q"])[:, :S] + xh * w["D"][:, None]
    y = C.rmsnorm(y.reshape(B, S, -1) * F.silu(zg), w["norm"], z["eps"])
    return h + mm(y, w["w_out"])


def loss(params: dict, tokens: torch.Tensor, cfg: dict, mm) -> torch.Tensor:
    """Mean next-token loss of float32 `params` ({path: tensor}) over
    `tokens` (B, S), each layer recomputed in the backward."""
    z = sizes(cfg)
    emb = params[("embed",)]
    h = emb[tokens.long()]
    names = ["w_z", "w_x", "w_B", "w_C", "w_dt", "w_out", "conv_x",
             "conv_B", "conv_C", "A_log", "D", "dt_bias", "norm"]
    for i in range(z["L"]):
        w = {n: params[BLOCK + ("ssm", n)][i] for n in names}
        w["ln1"] = params[BLOCK + ("ln1", "scale")][i]
        h = checkpoint(_layer, h, w, z, mm, use_reentrant=False)
    h = C.rmsnorm(h, params[("ln_f", "scale")], z["eps"])
    return C.next_token_loss(mm(h, emb.t()), tokens)
