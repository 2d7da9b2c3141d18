"""Model FLOPs of one training step, by arch_type, from the configuration's
published sizes: the products with weights at 6 x their parameters x
tokens (forward and backward), plus attention's or the SSD's own
products as the algorithm needs them, causal halved, forward and backward
(3 x the forward). Recomputation under remat is not counted; the
embedding lookup is no product. A later family adds a function here or a
file `flops_<arch_type>.py` beside this one."""

from __future__ import annotations

import importlib


def dense(cfg: dict, rows: int, seq: int) -> float:
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim", d // H)
    ff, V = cfg["intermediate_size"], cfg["vocab_size"]
    per_layer = d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff
    matmul = L * per_layer + d * V
    # q k^T and p v: 4 S^2 H hd a layer a sequence forward, causal halved
    attn = L * 3 * 2 * seq * seq * H * hd
    return 6.0 * matmul * rows * seq + rows * attn


def ssm(cfg: dict, rows: int, seq: int) -> float:
    s = cfg["ssm_cfg"]
    d, L = cfg["d_model"], cfg["n_layer"]
    di = s["expand"] * d
    H, P, N, G, Q = di // s["headdim"], s["headdim"], s["d_state"], \
        s["ngroups"], s["chunk_size"]
    m = cfg.get("pad_vocab_size_multiple", 1)
    V = -(-cfg["vocab_size"] // m) * m
    per_layer = d * (2 * di + 2 * G * N + H) + di * d
    matmul = L * per_layer + d * V
    # per chunk: C B^T (G Q^2 N) and the masked scores times x (H Q^2 P),
    # causal halved; B^T x into the chunk state and C times the entering
    # state (2 Q N P H each)
    chunk = G * Q * Q * N + H * Q * Q * P + 4 * Q * N * P * H
    ssd = L * 3 * (seq // Q) * chunk
    return 6.0 * matmul * rows * seq + rows * ssd


def step_flops(cfg: dict, rows: int, seq: int) -> float:
    """Model FLOPs of a step of `rows` sequences of `seq` tokens."""
    fn = globals().get(cfg["arch_type"])
    if fn is None:
        fn = importlib.import_module(
            f"portbench.flops_{cfg['arch_type']}").step_flops
    return fn(cfg, rows, seq)
