"""KV-cache autoregressive generation for the decoder LMs (GPT-2, Llama).

Counterpart of ``ray_tpu/models/generate.py``, with the same cache and the
same per-slot semantics:

- the cache is a fixed ``[L, B, KV, S, dh]`` buffer plus a per-slot
  ``pos`` vector, so continuous batching can give every slot its own
  offset;
- **the cache is written in place**: :func:`prefill_at` and
  :func:`decode_step` update the tensors of the ``cache`` dict they are
  given and return that same dict (the JAX package returns a new cache);
- prefill attention goes through :func:`ray_tpu_torch.ops.attention.attention`
  (the flash kernel on the card); decode attention is plain PyTorch.

Indexing out of range raises in PyTorch (a device-side assert on the
card, which ends the process), where XLA drops or clamps it.  So the
callers check the bounds on the host: a prompt must fit the cache, and a
slot may not decode past ``S``.

Cache columns of finished or idle slots keep being written at their
frozen position, which is harmless: a slot's mask never reaches an index
its own ``pos`` has not covered, and prefill overwrites ``[0, len)``
when a slot is reused.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.models.transformer import layers
from ray_tpu_torch.ops.attention import NEG_INF, attention
from ray_tpu_torch.ops.layers import layernorm, rmsnorm, rope
from ray_tpu_torch.util import tracing

Cache = Dict[str, torch.Tensor]


def family_of(cfg) -> str:
    """``"gpt2"`` or ``"llama"``; raises for a config generation does not
    take (an MoE GPT-2: the JAX package's generation has no MoE either)."""
    if getattr(cfg, "n_experts", 0) > 0:
        raise NotImplementedError(
            "KV-cache generation has no MoE blocks (nor does the JAX package's); "
            "use gpt2.apply for an MoE model's forward")
    if isinstance(cfg, LlamaConfig):
        return "llama"
    if isinstance(cfg, GPT2Config):
        return "gpt2"
    raise TypeError(f"no generation support for config {type(cfg).__name__}")


def kv_heads(cfg) -> int:
    return cfg.n_kv_heads if family_of(cfg) == "llama" else cfg.n_heads


def init_cache(cfg, n_slots: int, max_len: int, device: DeviceLike = None) -> Cache:
    """Fixed-size KV cache: k/v ``[L, B, KV, S, dh]`` in cfg.dtype plus
    per-slot ``pos`` (int64), on ``device`` (the card when None)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_slots, kv_heads(cfg), max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "pos": torch.zeros(n_slots, dtype=torch.long, device=dev),
    }


def _decode_attend(q, k_cache, v_cache, pos) -> torch.Tensor:
    """q ``[B, H, 1, dh]`` against the full cache ``[B, KV, S, dh]`` with
    a per-slot length mask ``j <= pos``; returns f32 ``[B, H, 1, dh]``.
    GQA folds the query heads onto their KV head by reshape.  Scores and
    the P·V product are f32 over the cache's values (bf16 products are
    exact in f32), as the reference's f32-accumulating einsums are."""
    B, H, _, dh = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    q = q.reshape(B, KV, H // KV, dh)
    scores = torch.einsum("bkgd,bksd->bkgs", q.float(), k_cache.float()) / (dh ** 0.5)
    mask = torch.arange(S, device=q.device)[None, None, None, :] <= pos[:, None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, H, 1, dh)


# ---------------------------------------------------------------------------
# per-family block math — one implementation serves prefill and decode:
# _qkv projects (post-rope, [B, heads, T, dh]), _post_attn applies the
# output projection and the FFN residuals; only the attention differs
# ---------------------------------------------------------------------------

def _gpt2_qkv(x, p, cfg: GPT2Config):
    """x [B, T, D] -> q, k, v [B, H, T, dh] (strided views of one qkv)."""
    B, T, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    c = lambda w: w.to(cfg.dtype)
    h = layernorm(x, c(p["ln1_w"]), c(p["ln1_b"]))
    qkv = h @ c(p["wqkv"]) + c(p["bqkv"])
    to_heads = lambda t: t.reshape(B, T, H, dh).transpose(1, 2)
    q, k, v = qkv.split(D, dim=-1)
    return to_heads(q), to_heads(k), to_heads(v)


def _gpt2_post_attn(x, out, p, cfg: GPT2Config):
    """out [B, T, D] (attention result, heads merged) -> next x."""
    c = lambda w: w.to(cfg.dtype)
    x = x + out @ c(p["wo"]) + c(p["bo"])
    h = layernorm(x, c(p["ln2_w"]), c(p["ln2_b"]))
    h = F.gelu(h @ c(p["w1"]) + c(p["b1"]), approximate="tanh")
    return x + h @ c(p["w2"]) + c(p["b2"])


def _llama_qkv(x, p, cfg: LlamaConfig, positions):
    """x [B, T, D] -> post-rope q [B, H, T, dh], k/v [B, KV, T, dh] (the
    GQA KV-head layout the cache stores)."""
    B, T, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    h = rmsnorm(x, p["attn_norm"].to(dt), eps=cfg.rms_eps)
    q = (h @ p["wq"].to(dt)).reshape(B, T, H, dh).transpose(1, 2)
    k = (h @ p["wk"].to(dt)).reshape(B, T, KV, dh).transpose(1, 2)
    v = (h @ p["wv"].to(dt)).reshape(B, T, KV, dh).transpose(1, 2)
    return (rope(q, positions, base=cfg.rope_base),
            rope(k, positions, base=cfg.rope_base), v)


def _llama_post_attn(x, out, p, cfg: LlamaConfig):
    dt = cfg.dtype
    x = x + out @ p["wo"].to(dt)
    h = rmsnorm(x, p["ffn_norm"].to(dt), eps=cfg.rms_eps)
    gated = F.silu(h @ p["w_gate"].to(dt)) * (h @ p["w_up"].to(dt))
    return x + gated @ p["w_down"].to(dt)


def _block(x, p, cfg, positions):
    """One prefill block: full causal self-attention over ``x [B, T, D]``;
    returns ``(x, (k, v))`` with k/v in the cache's KV-head layout."""
    B, T, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    if family_of(cfg) == "gpt2":
        q, k, v = _gpt2_qkv(x, p, cfg)
        kr, vr = k, v
    else:
        q, k, v = _llama_qkv(x, p, cfg, positions)
        kr = k.repeat_interleave(cfg.q_per_kv, dim=1)
        vr = v.repeat_interleave(cfg.q_per_kv, dim=1)
    out = attention(q, kr, vr, causal=True)
    out = out.transpose(1, 2).reshape(B, T, H * dh).to(cfg.dtype)
    post = _gpt2_post_attn if family_of(cfg) == "gpt2" else _llama_post_attn
    return post(x, out, p, cfg), (k, v)


# ---------------------------------------------------------------------------
# prefill / decode over the stacked layers
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg, positions):
    if family_of(cfg) == "gpt2":
        x = params["wte"][tokens] + params["wpe"][positions]
    else:
        x = params["tok_emb"][tokens]
    return x.to(cfg.dtype)


def _unembed(params, x, cfg):
    if family_of(cfg) == "gpt2":
        x = layernorm(x, params["lnf_w"].to(cfg.dtype), params["lnf_b"].to(cfg.dtype))
        w = params["wte"]
    else:
        x = rmsnorm(x, params["final_norm"].to(cfg.dtype), eps=cfg.rms_eps)
        w = params["tok_emb"]
    return (x @ w.T.to(cfg.dtype)).float()


def prefill_at(params, cfg, tokens: torch.Tensor, lengths: torch.Tensor,
               cache: Cache, slots: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Run the prompts ``tokens [B, Tp]`` (right-padded; true lengths
    ``lengths [B]``) and write their K/V into cache slots ``slots [B]``,
    **in place**.  Returns ``(last_logits [B, V] f32, cache)``, the same
    cache dict.  Positions are 0..Tp-1, so a slot is prefilled from
    scratch (its pos resets to its length).  Several rows may name the
    same slot (the engine parks its padding rows on one scratch slot);
    which row's K/V that slot keeps is then unspecified."""
    B, Tp = tokens.shape
    if Tp > cache["k"].shape[3]:
        raise ValueError(f"prompt width {Tp} exceeds the cache length "
                         f"{cache['k'].shape[3]}")
    positions = torch.arange(Tp, device=tokens.device)
    x = _embed(params, tokens, cfg, positions)
    for l, p in enumerate(layers(params["blocks"])):
        x, (k, v) = _block(x, p, cfg, positions)
        cache["k"][l, slots, :, :Tp] = k.to(cache["k"].dtype)
        cache["v"][l, slots, :, :Tp] = v.to(cache["v"].dtype)
    cache["pos"][slots] = lengths.to(torch.long)
    idx = (lengths - 1).to(torch.long)[:, None, None].expand(B, 1, x.shape[-1])
    last = _unembed(params, torch.gather(x, 1, idx), cfg)
    return last[:, 0, :], cache


def prefill(params, cfg, tokens: torch.Tensor, lengths: torch.Tensor,
            cache: Cache, slot: int) -> Tuple[torch.Tensor, Cache]:
    """:func:`prefill_at` with contiguous slots ``slot + [0..B)``."""
    B = tokens.shape[0]
    slots = slot + torch.arange(B, device=tokens.device)
    return prefill_at(params, cfg, tokens, lengths, cache, slots)


def decode_step(params, cfg, cache: Cache, tokens: torch.Tensor,
                active: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One token for every slot.  ``tokens [B]`` are each slot's last
    emitted token, written at ``pos`` then attended; ``active [B]`` bool
    gates the position advance.  Returns ``(logits [B, V] f32, cache)``:
    each layer's new K/V column and ``pos`` are written **in place**.
    The caller keeps every ``pos`` below the cache length ``S``."""
    fam = family_of(cfg)
    pos = cache["pos"]
    B = tokens.shape[0]
    H, dh, KV = cfg.n_heads, cfg.head_dim, kv_heads(cfg)
    positions = pos[:, None]  # [B, 1]: per-slot offsets
    x = _embed(params, tokens[:, None], cfg, positions)  # [B, 1, D]
    iota_b = torch.arange(B, device=tokens.device)[:, None]
    iota_kv = torch.arange(KV, device=tokens.device)[None, :]
    k_all, v_all = cache["k"], cache["v"]
    for l, p in enumerate(layers(params["blocks"])):
        if fam == "gpt2":
            q, k, v = _gpt2_qkv(x, p, cfg)  # [B, heads, 1, dh]
        else:
            q, k, v = _llama_qkv(x, p, cfg, positions)
        # one indexed write per tensor: only the new column (l, b, :, pos_b)
        k_all[l][iota_b, iota_kv, positions] = k[:, :, 0, :].to(k_all.dtype)
        v_all[l][iota_b, iota_kv, positions] = v[:, :, 0, :].to(v_all.dtype)
        with tracing.span("gen.decode_attend"):
            out = _decode_attend(q, k_all[l], v_all[l], pos)  # [B, H, 1, dh]
        out = out.transpose(1, 2).reshape(B, 1, H * dh).to(cfg.dtype)
        if fam == "gpt2":
            x = _gpt2_post_attn(x, out, p, cfg)
        else:
            x = _llama_post_attn(x, out, p, cfg)
    logits = _unembed(params, x, cfg)[:, 0, :]
    pos += active.to(pos.dtype)
    return logits, cache


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  *, temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Greedy (temperature 0) or temperature/top-k sampling; int64 [B].
    Sampling draws from ``generator`` (a generator on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_chunk(params, cfg, cache: Cache, tokens: torch.Tensor,
                 active: torch.Tensor, generator: Optional[torch.Generator] = None,
                 *, steps: int, temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None):
    """Run ``steps`` decode+sample iterations.  Returns ``(emitted [B,
    steps], cache, active)``; the cache is updated in place.  A slot that
    emits ``eos_id`` turns inactive mid-chunk (its pos freezes, and it
    repeats its last token)."""
    toks, act = tokens, active
    emitted = []
    for _ in range(steps):
        logits, cache = decode_step(params, cfg, cache, toks, act)
        nxt = sample_logits(logits, generator, temperature=temperature, top_k=top_k)
        nxt = torch.where(act, nxt, toks)
        if eos_id is not None:
            act = act & (nxt != eos_id)
        toks = nxt
        emitted.append(nxt)
    return torch.stack(emitted, dim=1), cache, act


def generate(params, cfg, prompts: torch.Tensor, lengths: torch.Tensor, *,
             max_new_tokens: int, generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 0,
             eos_id: Optional[int] = None) -> torch.Tensor:
    """One-shot batched generation (prefill, then a decode loop) on the
    prompts' device.  Returns ``[B, max_new_tokens]`` tokens (positions
    after an EOS repeat it).  The serving path is
    :class:`ray_tpu_torch.serve.llm.GenerationEngine`, which runs the same
    functions under continuous batching."""
    B, Tp = prompts.shape
    cache = init_cache(cfg, B, Tp + max_new_tokens, device=prompts.device)
    last_logits, cache = prefill(params, cfg, prompts, lengths, cache, 0)
    first = sample_logits(last_logits, generator, temperature=temperature, top_k=top_k)
    active = torch.ones(B, dtype=torch.bool, device=prompts.device)
    if eos_id is not None:
        active = active & (first != eos_id)
    rest, _, _ = decode_chunk(
        params, cfg, cache, first, active, generator, steps=max_new_tokens - 1,
        temperature=temperature, top_k=top_k, eos_id=eos_id)
    return torch.cat([first[:, None], rest], dim=1)
