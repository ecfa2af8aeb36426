"""``bert.from_hf`` and ``util.profiling`` of the port.

``from_hf`` reads a Hugging Face BERT checkpoint from a local directory:
here a random 12 x 768 ``transformers.BertModel`` with a vocab of 512,
built in memory and saved to ``tmp_path`` (nothing is downloaded).  Every
leaf must equal the JAX package's ``from_hf``'s.  Neither package
reproduces HF's own outputs from those weights (tanh GELU against HF's
erf, LayerNorm eps 1e-5 against 1e-12; ROADMAP C).
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models.transformer import named_leaves
from ray_tpu_torch.util import profiling


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.BertModel(transformers.BertConfig(vocab_size=512))
    path = tmp_path_factory.mktemp("bert")
    model.save_pretrained(path)
    return str(path)


def test_from_hf_matches_jax_leaf_for_leaf(hf_dir):
    from ray_tpu.models import bert as jbert

    jcfg, jparams = jbert.from_hf(hf_dir, num_classes=3)
    tcfg, tparams = tbert.from_hf(hf_dir, num_classes=3, device="cpu")
    assert (tcfg.vocab_size, tcfg.num_classes, tcfg.n_layers, tcfg.d_model) == (
        jcfg.vocab_size, jcfg.num_classes, jcfg.n_layers, jcfg.d_model) == (512, 3, 12, 768)
    got = dict(named_leaves(tparams))
    want = dict(named_leaves(jparams))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_from_hf_params_run_the_port_classifier(hf_dir):
    """The loaded params drive ``bert.apply``: finite logits, and zeros
    from the zero classifier."""
    cfg, params = tbert.from_hf(hf_dir, device="cpu")
    logits = tbert.apply(params, torch.randint(0, 512, (2, 16)), cfg)
    assert logits.shape == (2, 2) and torch.all(logits == 0)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = pathlib.Path(tmp_path).glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_nested_profile_trace_is_a_no_op(tmp_path):
    outer, inner = tmp_path / "outer", tmp_path / "inner"
    with profiling.profile_trace(str(outer)):
        with profiling.profile_trace(str(inner)):
            torch.ones(8) + 1
        assert profiling._trace_active
    assert not profiling._trace_active
    assert len(list(outer.glob("trace_*.json"))) == 1 and not inner.exists()


def test_span_runs_its_block_with_or_without_opentelemetry(monkeypatch):
    """``tracing.trace`` opens an OpenTelemetry span where the SDK imports;
    a ``tracing.span`` under it runs and records its row either way."""
    from ray_tpu_torch._private import events
    from ray_tpu_torch.util import tracing

    ran, traces = [], []
    since = events.buffer().last_seq()
    with tracing.trace("root", {"n": 1}) as root:
        with tracing.span("step", n=1):
            ran.append(1)
    traces.append(root["trace_id"])
    monkeypatch.setitem(sys.modules, "opentelemetry", None)  # import fails
    with tracing.trace("root") as root:
        with tracing.span("step"):
            ran.append(2)
    traces.append(root["trace_id"])
    assert ran == [1, 2]
    steps = [r["data"]["trace_id"] for r in events.local_events()
             if r["seq"] > since and r["message"] == "step"]
    assert steps == traces
