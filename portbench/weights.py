"""Weights made from the seed, on the device, in the port's layout.

The benchmark makes the weights itself and hands the same ones to the
port and to the reference; neither takes the other's.  A leaf is one
``randn`` on the device from one generator, in the dtype it is served in,
so a seed gives the same weights in every process on the same device.
Biases and norm gains are drawn too (GPT-2's and BERT's own inits set
them to 0 and 1), so that a path that drops one shows in the output.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from portbench.traffic import SEED_MOD


def dims(config: Dict[str, Any]) -> Dict[str, int]:
    """The port's sizes from a configuration file: the source's keys, with
    the padded vocabulary and the feed-forward width under ``assumed``."""
    a = config["assumed"]
    return {
        "d_model": config.get("n_embd", config.get("hidden_size")),
        "n_layers": config.get("n_layer", config.get("num_hidden_layers")),
        "n_heads": config.get("n_head", config.get("num_attention_heads")),
        "d_ff": a.get("d_ff", config.get("intermediate_size")),
        "max_seq_len": config.get("n_positions", config.get("max_position_embeddings")),
        "vocab_size": a["padded_vocab_size"],
    }


def _blocks(draw, L: int, D: int, Fd: int, res_std: float) -> Dict[str, torch.Tensor]:
    return {
        "ln1_w": 1.0 + 0.1 * draw((L, D)), "ln1_b": 0.02 * draw((L, D)),
        "wqkv": 0.02 * draw((L, D, 3 * D)), "bqkv": 0.02 * draw((L, 3 * D)),
        "wo": res_std * draw((L, D, D)), "bo": 0.02 * draw((L, D)),
        "ln2_w": 1.0 + 0.1 * draw((L, D)), "ln2_b": 0.02 * draw((L, D)),
        "w1": 0.02 * draw((L, D, Fd)), "b1": 0.02 * draw((L, Fd)),
        "w2": res_std * draw((L, Fd, D)), "b2": 0.02 * draw((L, D)),
    }


def _drawer(seed: int, device, dtype):
    g = torch.Generator(device=device).manual_seed(seed % SEED_MOD)
    return lambda shape: torch.randn(shape, generator=g, device=device, dtype=dtype)


def gpt2(config: Dict[str, Any], seed: int, device, dtype=torch.float32) -> Dict[str, Any]:
    """GPT-2's params as ``ray_tpu_torch.models.gpt2`` lays them out,
    every leaf in ``dtype``: normal 0.02, the residual projections
    0.02 / sqrt(2 L), positions 0.01, as GPT-2 initialises."""
    d = dims(config)
    L, D, Fd = d["n_layers"], d["d_model"], d["d_ff"]
    draw = _drawer(seed, device, dtype)
    return {
        "wte": 0.02 * draw((d["vocab_size"], D)),
        "wpe": 0.01 * draw((d["max_seq_len"], D)),
        "blocks": _blocks(draw, L, D, Fd, 0.02 / (2 * L) ** 0.5),
        "lnf_w": 1.0 + 0.1 * draw((D,)),
        "lnf_b": 0.02 * draw((D,)),
    }


def bert(config: Dict[str, Any], seed: int, device, block_dtype=torch.float32) -> Dict[str, Any]:
    """BERT's params as ``ray_tpu_torch.models.bert`` lays them out: the
    blocks in ``block_dtype``, the embeddings, pooler and classifier in
    f32, as the port reads them."""
    d = dims(config)
    L, D, Fd = d["n_layers"], d["d_model"], d["d_ff"]
    draw32 = _drawer(seed, device, torch.float32)
    drawb = _drawer(seed + 1, device, block_dtype)
    n_cls = int(config["assumed"]["num_labels"])
    return {
        "wte": 0.02 * draw32((d["vocab_size"], D)),
        "wpe": 0.02 * draw32((d["max_seq_len"], D)),
        "wtype": 0.02 * draw32((int(config["type_vocab_size"]), D)),
        "ln_emb_w": 1.0 + 0.1 * draw32((D,)), "ln_emb_b": 0.02 * draw32((D,)),
        "blocks": _blocks(drawb, L, D, Fd, 0.02),
        "pool_w": 0.02 * draw32((D, D)), "pool_b": 0.02 * draw32((D,)),
        "cls_w": 0.02 * draw32((D, n_cls)), "cls_b": 0.02 * draw32((n_cls,)),
    }
