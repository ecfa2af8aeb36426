"""Cells at a size the CPU runs in seconds: the same entries, files and
readers as the benchmark's, with the model, engine and traffic cut down
and ``device`` set to ``cpu``."""

from __future__ import annotations

import copy
from typing import Any, Dict

from portbench import harness

TINY_GPT2 = {"n_embd": 64, "n_layer": 2, "n_head": 4, "n_positions": 128}
TINY_GPT2_ASSUMED = {"padded_vocab_size": 512, "d_ff": 256, "dtype": "float32"}
TINY_BERT = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
             "intermediate_size": 256, "max_position_embeddings": 64}
TINY_BERT_ASSUMED = {"padded_vocab_size": 512, "dtype": "float32"}


def spec(workload: str, **cell_over) -> Dict[str, Any]:
    s = copy.deepcopy(harness.cell_spec(workload))
    s["device"] = "cpu"
    cfg = s["config"]
    if cfg.get("model_type") == "gpt2":
        cfg.update(TINY_GPT2)
        cfg["assumed"].update(TINY_GPT2_ASSUMED)
    elif cfg.get("model_type") == "bert":
        cfg.update(TINY_BERT)
        cfg["assumed"].update(TINY_BERT_ASSUMED)
    mix = s["traffic"]
    mix["vocab"] = 500
    if mix["kind"] == "closed_loop":
        mix.update(clients=6, requests=32,
                   prompt_len={"dist": "uniform", "lo": 4, "hi": 16},
                   output_len={"dist": "uniform", "lo": 8, "hi": 24})
        s["cell"]["engine"].update(n_slots=4, prefill_buckets=[8, 16], max_new_tokens=24,
                                   decode_chunk_steps=4)
        s["cell"]["settle_s"] = 1.0
        s["cell"]["check"]["sample"] = 4
    elif mix["kind"] == "train_batches":
        mix.update(batch=4, seq=32)
        s["cell"]["reference_rows"] = 2
    elif mix["kind"] == "score_rows":
        mix.update(batch=8, seq=32, block_rows=64)
        s["cell"].update(blocks=400, settle_s=0.5, trace_batches=2)
    s["cell"].update(cell_over)
    return s
