"""The port's BERT against ray_tpu.models.bert, from the same weights.

Weights are made by the JAX package and carried over by
``convert.from_jax_params``; tokens come from numpy.  Tolerances: f32
logits and the post-LN block 1e-5 absolute and relative (two layers of the
same f32 arithmetic in another summation order); bf16 logits 2e-2
absolute (the blocks round to bf16 at other places in the two packages;
the pooler and the classifier are f32 in both).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import bert as jbert
from ray_tpu.models import transformer as jtransformer
from ray_tpu_torch.convert import from_jax_params
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import transformer as ttransformer
from ray_tpu_torch.models.transformer import layers, named_leaves

TOL = 1e-5


def _pair(dtype=("f32", jnp.float32, torch.float32), seed=0):
    _, jd, td = dtype
    jcfg, tcfg = jbert.BertConfig.tiny(dtype=jd), tbert.BertConfig.tiny(dtype=td)
    jp = jbert.init(jcfg, jax.random.PRNGKey(seed))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _batch(cfg, t, seed, b=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, t)),
            rng.integers(0, cfg.type_vocab_size, (b, t)))


@pytest.mark.parametrize("make", ["base", "tiny"])
def test_config_fields_match_jax(make):
    """Every field and default of the JAX package's config, dtype aside."""
    j = dataclasses.asdict(getattr(jbert.BertConfig, make)())
    t = dataclasses.asdict(getattr(tbert.BertConfig, make)())
    assert j.pop("dtype") == jnp.bfloat16 and t.pop("dtype") == torch.bfloat16
    assert t == j


def test_init_shapes_match_jax():
    """BERT-base's tree of shapes, at one layer (nothing drawn at full
    depth)."""
    jcfg = jbert.BertConfig.base(n_layers=1)
    jshapes = dict(named_leaves(jax.eval_shape(lambda k: jbert.init(jcfg, k),
                                               jax.random.PRNGKey(0))))
    tparams = tbert.init(tbert.BertConfig.base(n_layers=1), device="cpu")
    assert {n: tuple(s.shape) for n, s in jshapes.items()} == \
        {n: tuple(t.shape) for n, t in named_leaves(tparams)}
    assert all(t.dtype == torch.float32 for _, t in named_leaves(tparams))


def test_post_ln_block_matches_jax():
    jcfg, jp, tcfg, tp = _pair()
    assert jcfg.post_ln and tcfg.post_ln and not tcfg.causal
    x = np.random.default_rng(1).standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    jblock = jax.tree.map(lambda a: a[1], jp["blocks"])
    want, jaux = jtransformer.apply_block(jnp.asarray(x), jblock, jcfg)
    got, aux = ttransformer.apply_block(torch.from_numpy(x), layers(tp["blocks"])[1], tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert aux.item() == float(jaux) == 0.0


@pytest.mark.parametrize("with_types", [False, True])
@pytest.mark.parametrize("t", [1, 17, 128])
def test_logits_match_jax(t, with_types):
    """T = 128 is the tiny config's max_seq_len; the others leave
    positions unread."""
    jcfg, jp, tcfg, tp = _pair()
    toks, types = _batch(jcfg, t, seed=t)
    want = jbert.apply(jp, jnp.asarray(toks), jcfg,
                       jnp.asarray(types) if with_types else None)
    got = tbert.apply(tp, torch.from_numpy(toks), tcfg,
                      torch.from_numpy(types) if with_types else None)
    assert got.dtype == torch.float32 and got.shape == (3, tcfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_bf16_logits_match_jax():
    jcfg, jp, tcfg, tp = _pair(("bf16", jnp.bfloat16, torch.bfloat16))
    toks, types = _batch(jcfg, 64, seed=5)
    want = jbert.apply(jp, jnp.asarray(toks), jcfg, jnp.asarray(types))
    got = tbert.apply(tp, torch.from_numpy(toks), tcfg, torch.from_numpy(types))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=0)


def test_sequence_longer_than_max_seq_len_raises():
    with pytest.raises(ValueError, match="max_seq_len"):
        tbert.apply({}, torch.zeros(1, 513, dtype=torch.long), tbert.BertConfig.base())
    with pytest.raises(ValueError, match="max_seq_len"):
        tbert.check_tokens(np.zeros((1, 513), np.int64), tbert.BertConfig.base())


def test_check_tokens_rejects_ids_outside_the_tables():
    cfg = tbert.BertConfig.tiny()
    toks, types = _batch(cfg, 16, seed=0)
    tbert.check_tokens(toks, cfg, types)
    for bad_toks, bad_types in ((toks * 0 + cfg.vocab_size, None), (toks * 0 - 1, None),
                                (toks, types * 0 + cfg.type_vocab_size), (toks[0], None)):
        with pytest.raises(ValueError):
            tbert.check_tokens(bad_toks, cfg, bad_types)


def test_init_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.init(tbert.BertConfig.tiny())
