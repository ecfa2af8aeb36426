"""On the card, at the cells' own sizes: the control (the reference in
float8 in the program's place) fails the limit the port passes.  Marked
``cuda``; each test decides inside itself whether a card is there.

    python3 -m pytest -q portbench/tests/test_pb_card.py   # on a machine with a card
"""

import pytest

from portbench import harness

SEEDS = (2 ** 31 + 41, 2 ** 31 + 42, 2 ** 31 + 43)


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_fails_a_limit_the_port_passes(seed):
    _card()
    from portbench import control

    spec = harness.cell_spec("gpt2-125m.train-b32")
    limits = spec["cell"]["check"]
    out = control.training(spec, seed)
    assert any(out["control"][k] > limits[k] for k in limits), out
    assert any(out["half_batch"][k] > limits[k] for k in limits), out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS[:1])
def test_prefill_logits_control_reads_further_than_the_port(seed):
    """GPT-2 at its published widths: the port's bf16 forward on 16
    prompts of 128 against the float32 reference, the float8 reference
    likewise; the widest gap of the token each puts first."""
    _card()
    import torch

    from ray_tpu_torch.models import gpt2

    from portbench import reference, traffic, weights

    spec = harness.cell_spec("gpt2-125m.decode-long")
    config = spec["config"]
    cfg = gpt2.GPT2Config(**weights.dims(config), dtype=torch.bfloat16, remat=False)
    params = weights.gpt2(config, seed, "cuda", dtype=torch.bfloat16)
    ids = torch.from_numpy(traffic.rng(seed).integers(0, 50257, (16, 128))).cuda()
    reference.no_tf32()
    with torch.no_grad():
        ref = reference.gpt2_logits(reference.f32(params), ids, cfg.n_heads)
        best = ref.max(-1).values

        def gap(logits):
            return float((best - ref.gather(-1, logits.argmax(-1, keepdim=True))[..., 0]).max())

        program = gap(gpt2.apply(params, ids, cfg))
        control = gap(reference.gpt2_logits(reference.f32(params), ids, cfg.n_heads,
                                            quant=reference.fp8))
    limit = spec["cell"]["check"]["logit_gap_max"]
    assert program < limit < control, (program, limit, control)
