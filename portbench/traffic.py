"""The one traffic generator: every mix is a data file in ``traffic/``.

A mix names its ``kind`` and its parameters:

- ``closed_loop``: ``clients`` callers, each sending its next request when
  the last one returns; ``prompt_len`` and ``output_len`` are length
  distributions, ``requests`` the number of distinct requests drawn;
- ``train_batches``: ``batch`` rows of ``seq`` + 1 packed token ids a step;
- ``score_rows``: rows of ``seq`` token ids, made in blocks of
  ``block_rows`` and scored in batches of ``batch``.

Every seed gets the same multiset of lengths (the distribution's
quantiles at evenly spaced points) and ids of its own, so that seeds
differ in what they send and not in how much; a closed loop replays
one order of them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np

# a seed is any whole number; numpy and torch take it modulo 2**63
SEED_MOD = 2 ** 63


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % SEED_MOD, stream])


def quantile(dist: Dict[str, Any], u: np.ndarray) -> np.ndarray:
    """Whole lengths at the quantiles ``u`` (in (0, 1)) of ``dist``:
    ``uniform`` over the integers ``lo..hi``, or ``lognormal`` with its
    ``median`` and ``sigma``, cut to ``lo..hi``."""
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if dist["dist"] == "uniform":
        out = lo + np.floor(u * (hi - lo + 1))
    elif dist["dist"] == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        out = np.round(float(dist["median"]) * np.exp(float(dist["sigma"]) * z))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(out, lo, hi).astype(np.int64)


def stratified(n: int, r: np.random.Generator) -> np.ndarray:
    """``n`` evenly spaced points of (0, 1), in the order ``r`` draws."""
    return r.permutation((np.arange(n) + 0.5) / n)


def closed_loop(mix: Dict[str, Any], seed: int) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """``(first, pool)``: each client's first request, then the requests
    clients take in turn.  The lengths are a fixed replay, the same for
    every seed (drawn from the mix's own ``lengths_seed``); the seed
    draws the ids.  A closed loop's timing follows its lengths alone, so
    seeds then differ in what they send and not in how the loop runs.
    A first request keeps only a share of its output (evenly spread over
    the clients), so the loop starts with the clients at all stages of
    their requests, as it would stand after running a long time."""
    n, clients = int(mix["requests"]), int(mix["clients"])
    fixed = rng(int(mix["lengths_seed"]))
    prompts = quantile(mix["prompt_len"], stratified(n + clients, fixed))
    outputs = quantile(mix["output_len"], stratified(n + clients, fixed))
    share = stratified(clients, fixed)
    r, vocab = rng(seed), int(mix["vocab"])
    reqs = [{"tokens": r.integers(0, vocab, int(p)).tolist(), "max_new": int(o)}
            for p, o in zip(prompts, outputs)]
    for req, s in zip(reqs[:clients], share):
        req["max_new"] = max(1, math.ceil(s * req["max_new"]))
    return reqs[:clients], reqs[clients:]


def train_batch(mix: Dict[str, Any], seed: int, step: int, device) -> Dict[str, Any]:
    """Step ``step``'s batch: ``{"tokens": [batch, seq + 1]}`` int64 ids,
    drawn on ``device`` from (seed, step)."""
    import torch

    g = torch.Generator(device=device).manual_seed((seed % SEED_MOD) ^ (step * 0x9E3779B1 + 1))
    return {"tokens": torch.randint(0, int(mix["vocab"]), (int(mix["batch"]), int(mix["seq"]) + 1),
                                    generator=g, device=device)}


def score_block(mix: Dict[str, Any], seed: int, index: int) -> np.ndarray:
    """Block ``index`` of the rows to score: ``[block_rows, seq]`` int64
    ids."""
    r = rng(seed, index + 1)
    return r.integers(0, int(mix["vocab"]), (int(mix["block_rows"]), int(mix["seq"])),
                      dtype=np.int64)
