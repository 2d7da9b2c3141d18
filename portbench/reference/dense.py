"""Plain float32 reference of a dense decoder of the llama layout (Yi-6B):
RMS norms, rotary embeddings on each head's halves, grouped-query causal
softmax attention, a SiLU-gated MLP, an untied head, and the next-token
loss. Read from the configuration's published keys; the parameter tree
uses the program's leaf names (the weights both sides are handed)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import common as C

BLOCK = ("blocks", "p0_attn")


def sizes(cfg: dict) -> dict:
    H = cfg["num_attention_heads"]
    return {"d": cfg["hidden_size"], "L": cfg["num_hidden_layers"],
            "V": cfg["vocab_size"], "ff": cfg["intermediate_size"], "H": H,
            "KV": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim", cfg["hidden_size"] // H),
            "eps": cfg["rms_norm_eps"], "theta": cfg["rope_theta"]}


def layout(cfg: dict) -> dict:
    """{path: leaf spec} of every parameter."""
    z = sizes(cfg)
    d, L, H, KV, hd, ff = z["d"], z["L"], z["H"], z["KV"], z["hd"], z["ff"]
    mats = {("attn", "wq"): (d, H * hd), ("attn", "wk"): (d, KV * hd),
            ("attn", "wv"): (d, KV * hd), ("attn", "wo"): (H * hd, d),
            ("mlp", "w1"): (d, ff), ("mlp", "w3"): (d, ff),
            ("mlp", "w2"): (ff, d)}
    out = {("embed",): C.spec((z["V"], d), scale=0.02),
           ("head",): C.spec((d, z["V"])),
           ("ln_f", "scale"): C.spec((d,), init="ones")}
    for p, shape in mats.items():
        out[BLOCK + p] = C.stacked(L, C.spec(shape))
    for n in ("ln1", "ln2"):
        out[BLOCK + (n, "scale")] = C.stacked(L, C.spec((d,), init="ones"))
    return out


def _layer(h, w, z, mm):
    B, S, _ = h.shape
    H, KV, hd = z["H"], z["KV"], z["hd"]
    x = C.rmsnorm(h, w["ln1"], z["eps"])
    q = C.rope(mm(x, w["wq"]).view(B, S, H, hd), z["theta"])
    k = C.rope(mm(x, w["wk"]).view(B, S, KV, hd), z["theta"])
    v = mm(x, w["wv"]).view(B, S, KV, hd)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    h = h + mm(o.reshape(B, S, H * hd), w["wo"])
    x = C.rmsnorm(h, w["ln2"], z["eps"])
    return h + mm(F.silu(mm(x, w["w1"])) * mm(x, w["w3"]), w["w2"])


def loss(params: dict, tokens: torch.Tensor, cfg: dict, mm) -> torch.Tensor:
    """Mean next-token loss of float32 `params` ({path: tensor}) over
    `tokens` (B, S), each layer recomputed in the backward."""
    z = sizes(cfg)
    h = params[("embed",)][tokens.long()]
    names = {"ln1": ("ln1", "scale"), "ln2": ("ln2", "scale"),
             "wq": ("attn", "wq"), "wk": ("attn", "wk"),
             "wv": ("attn", "wv"), "wo": ("attn", "wo"),
             "w1": ("mlp", "w1"), "w2": ("mlp", "w2"), "w3": ("mlp", "w3")}
    for i in range(z["L"]):
        w = {k: params[BLOCK + p][i] for k, p in names.items()}
        h = checkpoint(_layer, h, w, z, mm, use_reentrant=False)
    h = C.rmsnorm(h, params[("ln_f", "scale")], z["eps"])
    return C.next_token_loss(mm(h, params[("head",)]), tokens)
