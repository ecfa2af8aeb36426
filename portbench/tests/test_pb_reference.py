"""The plain reference agrees with the port at tiny sizes on the CPU, in
float32: GPT-2's logits through prefill and the KV cache, one training
step's loss and update, BERT's class logits.  And the control (the
float8 reference) reads further from the float32 reference than the
port in bfloat16 does."""

import torch

from portbench import reference, weights
from portbench.tests import tiny

SEED = 2 ** 31 + 3


def _gpt2(dtype):
    from ray_tpu_torch.models.gpt2 import GPT2Config

    config = tiny.spec("gpt2-125m.decode-long")["config"]
    return config, GPT2Config(**weights.dims(config), dtype=dtype, remat=False)


def test_gpt2_forward_and_kv_cache_decode_match_the_reference():
    from ray_tpu_torch.models import generate as gen
    from ray_tpu_torch.models import gpt2

    config, cfg = _gpt2(torch.float32)
    params = weights.gpt2(config, SEED, "cpu")
    tokens = torch.randint(0, 500, (2, 12), generator=torch.Generator().manual_seed(1))
    ref = reference.gpt2_logits(reference.f32(params), tokens, cfg.n_heads)
    assert torch.allclose(gpt2.apply(params, tokens, cfg), ref, atol=1e-5)
    cache = gen.init_cache(cfg, 2, 16, "cpu")
    last, cache = gen.prefill(params, cfg, tokens[:, :8], torch.tensor([8, 8]), cache, 0)
    assert torch.allclose(last, ref[:, 7], atol=1e-5)
    for t in range(8, 12):
        logits, cache = gen.decode_step(params, cfg, cache, tokens[:, t], torch.ones(2, dtype=torch.bool))
        assert torch.allclose(logits, ref[:, t], atol=1e-5)


def test_the_first_training_steps_match_the_reference():
    """Three steps of the port's recipe against the reference's, by the
    three numbers the training cells compare (Adam's normalised update
    makes an element-wise comparison of the params ill-conditioned)."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.transformer import train_state

    from portbench.entries import train_lm

    spec = tiny.spec("gpt2-125m.train-b32")
    config, o = spec["config"], dict(spec["cell"]["optimizer"], warmup=2)
    cfg = gpt2.GPT2Config(**weights.dims(config), dtype=torch.float32, remat=False)
    g = torch.Generator().manual_seed(2)
    batches = [torch.randint(0, 500, (2, 17), generator=g) for _ in range(3)]
    opt = gpt2.make_optimizer(o["lr"], o["weight_decay"], o["warmup"], o["total_steps"])
    params = weights.gpt2(config, SEED, "cpu")
    start = {n: t.clone() for n, t in reference.leaves(params)}
    state = train_state(params, opt)
    step = gpt2.make_train_step(cfg, opt)
    names = {id(t): n for n, t in reference.leaves(params)}
    losses, grads = [], None
    for b in batches:
        state, m = step(state, {"tokens": b})
        losses.append(float(m["loss"]))
        if grads is None:
            adamw = state["opt_state"]["adamw"]
            grads = {names[id(p)]: adamw.state[p]["exp_avg"] / (1 - o["betas"][0])
                     for grp in adamw.param_groups for p in grp["params"]}
    prog = {"losses": losses, "grad_norms": {n: float(g.norm()) for n, g in grads.items()},
            "grad_blocks": {n: train_lm.block_norms(g) for n, g in grads.items()},
            "change": {n: train_lm.block_norms(t.detach() - start[n])
                       for n, t in reference.leaves(state["params"])}}
    ref_params = reference.f32(weights.gpt2(config, SEED, "cpu"))
    out = reference.train_steps(ref_params, batches, cfg.n_heads, o, 1)
    ref = {"losses": out["losses"], "grad_norms": out["grad_norms"],
           "grad_blocks": {n: train_lm.block_norms(g) for n, g in out["first_grads"].items()},
           "change": {n: train_lm.block_norms(t - start[n])
                      for n, t in reference.leaves(out["params"])}}
    gaps = train_lm.compare(prog, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_norm_gap"] < 1e-4, gaps
    assert gaps["change_norm_gap"] < 1e-3 and gaps["grad_block_gap"] < 1e-4, gaps


def test_bert_class_logits_match_the_reference():
    from ray_tpu_torch.models import bert

    spec = tiny.spec("bert-base.score-512")
    config = spec["config"]
    cfg = bert.BertConfig(**weights.dims(config), dtype=torch.float32, remat=False)
    params = weights.bert(config, SEED, "cpu")
    tokens = torch.randint(0, 500, (3, 20), generator=torch.Generator().manual_seed(3))
    got = bert.apply(params, tokens, cfg, token_types=torch.zeros_like(tokens))
    assert torch.allclose(got, reference.bert_logits(reference.f32(params), tokens, cfg.n_heads),
                          atol=1e-5)


def test_the_float8_control_reads_further_than_bfloat16():
    from ray_tpu_torch.models import gpt2

    config, cfg = _gpt2(torch.bfloat16)
    params = weights.gpt2(config, SEED, "cpu", dtype=torch.bfloat16)
    tokens = torch.randint(0, 500, (4, 32), generator=torch.Generator().manual_seed(4))
    ref = reference.gpt2_logits(reference.f32(params), tokens, cfg.n_heads)
    best = ref.max(dim=-1).values

    def gap(logits):
        return float((best - ref.gather(-1, logits.argmax(-1, keepdim=True))[..., 0]).max())

    program = gap(gpt2.apply(params, tokens, cfg))
    control = gap(reference.gpt2_logits(reference.f32(params), tokens, cfg.n_heads,
                                        quant=reference.fp8, dtype=torch.bfloat16))
    assert control > 3 * program
