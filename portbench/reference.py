"""The plain reference: GPT-2 and BERT in float32 PyTorch, no kernels,
no cache, no batching tricks, TF32 off.

It imports nothing of the port.  It follows the published models as the
port states them: pre-LN GPT-2 with the tanh GELU and LayerNorm eps 1e-5
(GPT-2's ``gelu_new`` and ``layer_norm_epsilon``), a tied LM head;
post-LN BERT with the port's tanh GELU and eps 1e-5 (BERT's own are erf
and 1e-12: the port's ``bert.from_hf`` says so too), a tanh pooler over
[CLS] and a linear classifier.  Params come in the port's layout
(``weights.py``), whatever their dtype, and are read as float32.

``dtype`` is the activations' type (float32 unless asked), with the
port's habits where it is lower: norms and softmax in float32, their
results cast back.  The control is ``dtype=torch.bfloat16`` with
``quant=fp8``: every matrix product's operands rounded to float8 (e4m3),
each scaled per tensor, the rest in the bfloat16 the configurations
state: the reference one precision below them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its
    largest magnitude onto 448), back in ``x``'s dtype."""
    s = x.detach().float().abs().amax().clamp(min=1e-30) / 448.0
    q = ((x.float() / s).to(torch.float8_e4m3fn).to(torch.float32) * s).to(x.dtype)
    return x + (q - x).detach()  # rounded forward, straight-through backward


def _mm(a: torch.Tensor, b: torch.Tensor, quant: Quant) -> torch.Tensor:
    if quant is not None:
        a, b = quant(a), quant(b)
    return a @ b


def f32(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.detach().to(torch.float32)


def _ln(x, w, b):
    """LayerNorm in float32 (eps 1e-5), cast back, then its gain and bias."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-5).to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def _attend(q, k, v, causal: bool, quant: Quant):
    """q, k, v [B, H, T, dh] -> [B, H, T, dh], scores materialised, the
    softmax in float32."""
    dh = q.shape[-1]
    s = _mm(q, k.transpose(-1, -2), quant).float() / math.sqrt(dh)
    if causal:
        T = q.shape[-2]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return _mm(torch.softmax(s, dim=-1).to(v.dtype), v, quant)


def _block(x, p: Dict[str, torch.Tensor], l: int, n_heads: int, causal: bool,
           post_ln: bool, quant: Quant):
    B, T, D = x.shape
    dh = D // n_heads
    w = lambda name: p[name][l].to(x.dtype)

    def attn(h):
        qkv = _mm(h, w("wqkv"), quant) + w("bqkv")
        heads = [t.reshape(B, T, n_heads, dh).transpose(1, 2) for t in qkv.split(D, dim=-1)]
        o = _attend(*heads, causal, quant).transpose(1, 2).reshape(B, T, D)
        return _mm(o, w("wo"), quant) + w("bo")

    def ffn(h):
        h = F.gelu(_mm(h, w("w1"), quant) + w("b1"), approximate="tanh")
        return _mm(h, w("w2"), quant) + w("b2")

    if post_ln:
        x = _ln(x + attn(x), p["ln1_w"][l], p["ln1_b"][l])
        return _ln(x + ffn(x), p["ln2_w"][l], p["ln2_b"][l])
    x = x + attn(_ln(x, p["ln1_w"][l], p["ln1_b"][l]))
    return x + ffn(_ln(x, p["ln2_w"][l], p["ln2_b"][l]))


def gpt2_logits(params: Dict[str, Any], tokens: torch.Tensor, n_heads: int,
                quant: Quant = None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] in float32."""
    B, T = tokens.shape
    x = (params["wte"][tokens] + params["wpe"][:T]).to(dtype)
    blocks = params["blocks"]
    for l in range(blocks["wqkv"].shape[0]):
        x = _block(x, blocks, l, n_heads, True, False, quant)
    x = _ln(x, params["lnf_w"], params["lnf_b"])
    return _mm(x, params["wte"].T.to(dtype), quant).float()


def gpt2_loss(params: Dict[str, Any], tokens: torch.Tensor, n_heads: int,
              quant: Quant = None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mean next-token cross entropy over ``tokens [B, T + 1]``, summed
    here over rows (the caller divides by every row's tokens)."""
    logits = gpt2_logits(params, tokens[:, :-1], n_heads, quant, dtype)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1), reduction="sum")


def bert_logits(params: Dict[str, Any], tokens: torch.Tensor, n_heads: int,
                quant: Quant = None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """tokens [B, T] (token type 0) -> class logits [B, C] in float32; the
    embeddings' sum and norm, the pooler and the classifier in float32,
    as the port reads them."""
    B, T = tokens.shape
    x = params["wte"][tokens] + params["wpe"][:T] + params["wtype"][0]
    x = _ln(x, params["ln_emb_w"], params["ln_emb_b"]).to(dtype)
    blocks = params["blocks"]
    for l in range(blocks["wqkv"].shape[0]):
        x = _block(x, blocks, l, n_heads, False, True, quant)
    cls = torch.tanh(_mm(x[:, 0].float(), params["pool_w"], quant) + params["pool_b"])
    return _mm(cls, params["cls_w"], quant) + params["cls_b"]


# ---------------------------------------------------------------------------
# the training recipe: clip to a global norm of 1, AdamW, warmup-cosine
# ---------------------------------------------------------------------------

def leaves(tree: Dict[str, Any], prefix: str = "") -> List[tuple]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += leaves(v, f"{prefix}{k}.")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def warmup_cosine(opt: Dict[str, Any], count: int) -> float:
    """optax's ``warmup_cosine_decay_schedule`` from 0 to ``lr`` over
    ``warmup`` updates, then down to ``lr / 10`` at ``total_steps``."""
    peak, warm = float(opt["lr"]), int(opt["warmup"])
    total = max(int(opt["total_steps"]), warm + 1)
    if count < warm:
        return peak * count / warm
    t = min(count - warm, total - warm)
    cos = 0.5 * (1.0 + math.cos(math.pi * t / (total - warm)))
    return peak * (0.9 * cos + 0.1)


def train_steps(params: Dict[str, Any], batches: List[torch.Tensor], n_heads: int,
                opt: Dict[str, Any], rows_per_block: int, quant: Quant = None,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The recipe's first ``len(batches)`` updates from ``params`` (float32,
    updated in place): each step's loss, each leaf's gradient after the
    first step's clipping (as the optimizer's first moment gives it) and
    its norm, and the params at the end.  The gradient
    of a batch is summed over blocks of ``rows_per_block`` rows."""
    b1, b2 = opt["betas"]
    eps, wd = float(opt["eps"]), float(opt["weight_decay"])
    named = leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    m = {n: torch.zeros_like(t) for n, t in named}
    v = {n: torch.zeros_like(t) for n, t in named}
    losses, first = [], None
    for i, batch in enumerate(batches):
        for _, t in named:
            t.grad = None
        n_tok = batch[:, 1:].numel()
        total = 0.0
        for r in range(0, batch.shape[0], rows_per_block):
            loss = gpt2_loss(params, batch[r:r + rows_per_block], n_heads, quant, dtype) / n_tok
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            gnorm = torch.sqrt(sum((t.grad ** 2).sum() for _, t in named))
            coef = min(1.0, 1.0 / (float(gnorm) + 1e-6))
            lr = warmup_cosine(opt, i)
            step = i + 1
            for n, t in named:
                g = t.grad * coef
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                if t.ndim >= 2:
                    t.mul_(1 - lr * wd)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                t.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** step))
            if first is None:
                first = {n: m[n] / (1 - b1) for n, _ in named}
    for _, t in named:
        t.requires_grad_(False)
        t.grad = None
    return {"losses": losses, "grad_norms": {n: float(g.norm()) for n, g in first.items()},
            "first_grads": first, "params": params}
