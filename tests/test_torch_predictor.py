"""The port's Checkpoint and TorchPredictor against ray_tpu.air's
Checkpoint and ray_tpu.train's JaxPredictor.

The test imports both packages; the port imports nothing of ray_tpu.
TorchPredictor's BERT logits are held to JaxPredictor's at 1e-5 absolute
and relative (f32, tiny BERT, the same weights), and the labels are
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.air import Checkpoint as JaxCheckpoint
from ray_tpu.models import bert as jbert
from ray_tpu.train.predictor import JaxPredictor
from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.train import Predictor, TorchPredictor


def _linear_apply(params, batch):
    return batch @ params["w"] + params["b"]


@pytest.fixture
def linear_checkpoint():
    w = np.array([[2.0], [3.0]], np.float32)
    b = np.array([1.0], np.float32)
    return Checkpoint.from_dict({"params": {"w": w, "b": b}, "step": 7})


def _assert_same_dict(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_same_dict(got[k], v)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v))


def test_checkpoint_round_trips(tmp_path, linear_checkpoint):
    """dict -> directory -> URI (file:// and a plain path) -> dict."""
    want = linear_checkpoint.to_dict()
    d = Checkpoint.from_directory(linear_checkpoint.to_directory(str(tmp_path / "a")))
    _assert_same_dict(d.to_dict(), want)
    uri = d.to_uri(f"file://{tmp_path / 'b'}")
    _assert_same_dict(Checkpoint.from_uri(uri).to_dict(), want)
    _assert_same_dict(Checkpoint.from_uri(str(tmp_path / "b")).to_dict(), want)
    copy = Checkpoint.from_uri(uri).to_directory(str(tmp_path / "c"))
    _assert_same_dict(Checkpoint.from_directory(copy).to_dict(), want)
    with pytest.raises(ValueError, match="not a directory"):
        Checkpoint.from_directory(str(tmp_path / "missing"))
    with pytest.raises(ValueError):
        Checkpoint()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_directories_read_across_packages(tmp_path, writer, linear_checkpoint):
    """The same checkpoint.pkl layout: a directory either package wrote
    with numpy leaves reads in the other."""
    data = linear_checkpoint.to_dict()
    src, dst = (JaxCheckpoint, Checkpoint) if writer == "jax" else (Checkpoint, JaxCheckpoint)
    path = src.from_dict(data).to_directory(str(tmp_path / "ckpt"))
    _assert_same_dict(dst.from_directory(path).to_dict(), data)


def test_directory_without_a_dict_gives_its_files(tmp_path):
    (tmp_path / "weights.bin").write_bytes(b"\x01\x02")
    assert Checkpoint.from_directory(str(tmp_path)).to_dict() == {"weights.bin": b"\x01\x02"}


def test_save_and_load_torch(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": 3}
    ckpt = Checkpoint.save_torch(state, str(tmp_path / "t"))
    got = ckpt.load_torch()
    assert got["step"] == 3 and torch.equal(got["params"]["w"], state["params"]["w"])
    with pytest.raises(ValueError, match="directory"):
        Checkpoint.from_dict(state).load_torch()


def test_object_ref_forms_raise():
    """Only an ``ObjectRef`` makes an object-store checkpoint (the round
    trip through the runtime is ``test_torch_trainer.py``'s)."""
    with pytest.raises(TypeError, match="ObjectRef"):
        Checkpoint.from_object_ref(object())
    with pytest.raises(ValueError, match="exactly one"):
        Checkpoint(data={}, obj_ref=object())


def test_torch_predictor_single_batch(linear_checkpoint):
    """test_predictor.py's linear case."""
    pred = TorchPredictor.from_checkpoint(linear_checkpoint, _linear_apply, device="cpu")
    out = pred.predict(np.array([[1.0, 1.0], [0.0, 2.0]], np.float32))
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, [[6.0], [7.0]], rtol=1e-6)


def test_torch_predictor_dict_batch_and_whole_dict_params():
    """A checkpoint whose dict is the params themselves, and a dict batch
    with a dict of outputs."""
    ckpt = Checkpoint.from_dict({"w": np.eye(2, dtype=np.float32) * 2})
    pred = TorchPredictor.from_checkpoint(
        ckpt, lambda p, b: {"y": b["x"] @ p["w"], "half": (b["x"] / 2).bfloat16()},
        device="cpu")
    out = pred.predict({"x": np.array([[1.0, 3.0]], np.float32)})
    np.testing.assert_array_equal(out["y"], [[2.0, 6.0]])
    assert out["half"].dtype == np.float32
    np.testing.assert_array_equal(out["half"], [[0.5, 1.5]])


def test_predictor_base_raises(linear_checkpoint):
    with pytest.raises(NotImplementedError):
        Predictor.from_checkpoint(linear_checkpoint)
    with pytest.raises(NotImplementedError):
        Predictor().predict(np.zeros(1))


def test_torch_predictor_matches_jax_predictor_on_bert(tmp_path):
    """Tiny BERT, f32: the JAX package's weights in a checkpoint directory,
    read by both predictors; the same numpy batch, checked on the host."""
    jcfg, tcfg = jbert.BertConfig.tiny(dtype=jnp.float32), tbert.BertConfig.tiny(dtype=torch.float32)
    params = jax.tree.map(np.asarray, jbert.init(jcfg, jax.random.PRNGKey(0)))
    path = JaxCheckpoint.from_dict({"params": params}).to_directory(str(tmp_path / "bert"))
    toks = np.random.default_rng(0).integers(1, jcfg.vocab_size, (5, 24))
    tbert.check_tokens(toks, tcfg)
    jpred = JaxPredictor.from_checkpoint(JaxCheckpoint.from_directory(path),
                                         lambda p, t: jbert.apply(p, t, jcfg))
    tpred = TorchPredictor.from_checkpoint(Checkpoint.from_directory(path),
                                           lambda p, t: tbert.apply(p, t, tcfg), device="cpu")
    want, got = jpred.predict(jnp.asarray(toks)), tpred.predict(toks)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_torch_predictor_without_a_device_raises_without_a_card(monkeypatch, linear_checkpoint):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchPredictor.from_checkpoint(linear_checkpoint, _linear_apply)


def _tree_apply(params, batch):
    """A nested-dict batch in, a tuple holding a dict and a list out."""
    x = batch["inputs"]["x"] @ params["w"]
    scale = batch["inputs"]["scale"][0]
    return x * scale, {"sum": x.sum(-1), "parts": [x[:, :1], batch["mask"]["m"]]}


def test_torch_predictor_returns_jax_predictors_tree():
    """A tuple output and a nested-dict batch: the same tree back as
    ``JaxPredictor.predict`` gives (a tuple stays a tuple, a list a
    list), with equal f32 values."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 2)).astype(np.float32)}
    batch = {"inputs": {"x": rng.standard_normal((4, 3)).astype(np.float32),
                        "scale": np.array([2.0], np.float32)},
             "mask": {"m": np.array([True, False, True, True])}}
    want = JaxPredictor(params, _tree_apply).predict(jax.tree.map(jnp.asarray, batch))
    got = TorchPredictor(params, _tree_apply, device="cpu").predict(batch)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert isinstance(got, tuple) and isinstance(got[1]["parts"], list)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
