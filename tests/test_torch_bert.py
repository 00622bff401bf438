"""The port's BERT ensemble (``tpuserver_torch.models.bert``) held against
``tpuserver/models/bert.py`` on the CPU, the JAX package's own draw
carried across by ``params_from_jax`` (bf16 through its bits).

The comparisons are of the pooler's output before its tanh, and of
``POOLED``: with random weights a third of ``POOLED``'s entries lie
beyond 0.999, where the tanh hides almost any error.  The JAX side's
pre-tanh value is ``jax_fn`` with ``jax.numpy.tanh`` patched to the
identity.  Row-relative error: each row's largest |port - JAX| over its
largest |JAX|.  Narrow configs patch both modules' constants (2 layers,
d_model 64, 4 heads, d_ff 128, vocab 4096; the JAX package's files are
not edited); one case runs BERT-base at full width.

- float32, both trees cast: within ``F32_TOL``;
- bf16: within ``BERT_TOL`` of the float32 forward at full width, the
  tolerance ``chip_smoke.py`` phase 9 (a) holds the card's bf16 to, and
  within ``2 * BERT_TOL`` of JAX's own bf16 forward (the two frameworks
  round at other places: XLA may keep a fused residual add or GELU in
  float32 where torch rounds after each op, so each side carries its own
  bf16 error against the float32 function);
- ``POOLED`` within the pre-tanh limit times the row's largest pre-tanh
  value, absolute (the tanh moves no value by more than its input moved);
- phase 9 (a)'s two planted faults at full width, each beyond ten times
  ``BERT_TOL``;
- the tokenizer bitwise, the clamped gather, the ensemble through the
  core and a ``ModelStreamInfer`` stream through the gRPC front end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tritonclient.grpc as grpcclient
from tpuserver.models import bert as jb
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.grpc_server import GrpcServer
from tpuserver_torch.models import bert as tb
from tpuserver_torch.models.tree import tree_cast, tree_leaves
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

F32_TOL = 1e-4
# bf16 pre-tanh against float32 (the same weights), row-relative, at full
# width: 0.0101-0.0105 measured on the CPU over 8 rows (the port, and
# JAX's own bf16 0.0107); the last layer's MLP skipped moves 8 rows by
# 0.20-0.23 at most, the mask ignored moves a padded row by 0.79-1.26
BERT_TOL = 1.5e-2
NARROW = {"N_LAYERS": 2, "D_MODEL": 64, "N_HEADS": 4, "D_FF": 128,
          "VOCAB": 4096}


def row_rel_err(out, ref):
    out = np.asarray(out, np.float64).reshape(-1, np.shape(ref)[-1])
    ref = np.asarray(ref, np.float64).reshape(out.shape)
    return float((np.abs(out - ref).max(-1)
                  / np.maximum(np.abs(ref).max(-1), 1e-30)).max())


def pooled_err_ok(pooled, ref_pooled, ref_pre, tol):
    """``POOLED`` against the reference's within ``tol`` times each row's
    largest pre-tanh value, absolute."""
    pre = np.abs(np.asarray(ref_pre, np.float64)).reshape(
        -1, np.shape(ref_pre)[-1]).max(-1, keepdims=True)
    err = np.abs(np.asarray(pooled, np.float64) - np.asarray(
        ref_pooled, np.float64)).reshape(pre.shape[0], -1)
    return bool((err <= tol * pre).all())


@pytest.fixture
def narrow(monkeypatch):
    for mod in (jb, tb):
        for key, value in NARROW.items():
            monkeypatch.setattr(mod, key, value)


def _inputs(batch, vocab, seed=0):
    """``batch`` rows of ids in the tokenizer's range, [CLS] first; at
    batch 2 and up row 1 is padded from token 40 (ids 0 there), at 8 row 5
    from token 10 too.  Batch 1 is a 1-D request."""
    rng = np.random.RandomState(seed)
    n = max(batch, 1)
    ids = rng.randint(1000, vocab - 100, (n, jb.SEQ_LEN)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((n, jb.SEQ_LEN), np.int32)
    for row, start in ((1, 40), (5, 10)):
        if row < n:
            mask[row, start:] = 0
            ids[row, start:] = 0
            ids[row, start - 1] = 102
    if batch == 1:
        return ids[0], mask[0]
    return ids, mask


def _jax_forward(monkeypatch, model, ids, mask, pre_tanh):
    """JAX's ``jax_fn`` under a jit of its own (its constants are read at
    trace time), the tanh patched out when ``pre_tanh``."""
    with monkeypatch.context() as m:
        if pre_tanh:
            m.setattr(jax.numpy, "tanh", lambda x: x)
        out = jax.jit(lambda i, k: model.jax_fn(i, k))(ids, mask)
    return np.asarray(out["POOLED"], np.float32)


def _jax_model(dtype):
    """A JAX encoder of the current constants, its tree in ``dtype``, and
    that tree's bf16 original as numpy leaves."""
    model = jb.BertEncoderModel()
    params = model._get_params()
    if dtype == "float32":
        model._params = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32), params)
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(np_tree, dtype):
    params = tb.BertEncoderModel.params_from_jax(np_tree, "cpu")
    if dtype == "float32":
        params = tree_cast(params, torch.float32)
    return tb.BertEncoderModel(device="cpu", params=params,
                               dtype=getattr(torch, dtype))


def _port_outputs(model, ids, mask, params=None):
    with torch.inference_mode():
        pre = model.pooled_logits(torch.from_numpy(ids),
                                  torch.from_numpy(mask), params=params)
        pooled = model.execute({"INPUT_IDS": ids, "ATTENTION_MASK": mask},
                               None)["POOLED"]
    return pre.numpy(), pooled.numpy()


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_encoder_matches_jax(narrow, monkeypatch, dtype, batch):
    ids, mask = _inputs(batch, tb.VOCAB, seed=batch)
    jax_model, np_tree = _jax_model(dtype)
    ref_pre = _jax_forward(monkeypatch, jax_model, ids, mask, True)
    ref_pooled = _jax_forward(monkeypatch, jax_model, ids, mask, False)
    pre, pooled = _port_outputs(_port_model(np_tree, dtype), ids, mask)
    assert pre.shape == pooled.shape == ref_pre.shape
    assert pre.shape == ((64,) if batch == 1 else (batch, 64))
    assert pre.dtype == pooled.dtype == np.float32
    tol = F32_TOL if dtype == "float32" else 2 * BERT_TOL
    assert row_rel_err(pre, ref_pre) <= tol
    assert pooled_err_ok(pooled, ref_pooled, ref_pre, tol)
    if dtype == "float32":
        assert row_rel_err(pooled, ref_pooled) <= F32_TOL


def test_full_width_bert_base_matches_jax(monkeypatch):
    """BERT-base at batch 1 (a 1-D request): float32 within ``F32_TOL``,
    the served bf16 within ``BERT_TOL`` of JAX's float32 forward and
    within twice it of JAX's bf16."""
    ids, mask = _inputs(1, tb.VOCAB, seed=11)
    jax_model, np_tree = _jax_model("bfloat16")
    bf16_pre = _jax_forward(monkeypatch, jax_model, ids, mask, True)
    jax_model._params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), jax_model._params)
    f32_pre = _jax_forward(monkeypatch, jax_model, ids, mask, True)
    f32_pooled = np.asarray(jnp.tanh(f32_pre))
    pre, pooled = _port_outputs(_port_model(np_tree, "float32"), ids, mask)
    assert pre.shape == (tb.D_MODEL,)
    assert row_rel_err(pre, f32_pre) <= F32_TOL
    assert row_rel_err(pooled, f32_pooled) <= F32_TOL
    pre, pooled = _port_outputs(_port_model(np_tree, "bfloat16"), ids, mask)
    assert row_rel_err(pre, f32_pre) <= BERT_TOL
    assert pooled_err_ok(pooled, f32_pooled, f32_pre, BERT_TOL)
    assert row_rel_err(pre, bf16_pre) <= 2 * BERT_TOL
    assert row_rel_err(bf16_pre, f32_pre) <= BERT_TOL


@pytest.fixture(scope="module")
def full_width():
    """The port's full-width encoder on its own seed-0 draw (bf16), that
    draw in float32, and phase 9 (a)'s batch of 8 (row 1 padded)."""
    model = tb.BertEncoderModel(device="cpu", seed=0)
    rng = np.random.RandomState(9)
    ids = rng.randint(1000, 29000, (8, tb.SEQ_LEN)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((8, tb.SEQ_LEN), np.int32)
    mask[1, 40:] = 0
    ids[1, 40:] = 0
    return model, tree_cast(model.params(), torch.float32), ids, mask


def _skip_last_mlp(params):
    faulty = dict(params, layers=list(params["layers"]))
    last = dict(faulty["layers"][-1])
    last["w_out"] = torch.zeros_like(last["w_out"])
    faulty["layers"][-1] = last
    return faulty


@pytest.mark.parametrize("fault", ["none", "skip_last_mlp", "mask_ignored"])
def test_planted_faults_exceed_bert_tol(full_width, fault):
    """Phase 9 (a) on the CPU: bf16 against float32 at full width, batch
    8, within ``BERT_TOL``; each planted fault beyond ten times it (the
    mask's on the padded row)."""
    model, p32, ids, mask = full_width
    with torch.inference_mode():
        ref = model.pooled_logits(torch.from_numpy(ids),
                                  torch.from_numpy(mask), params=p32).numpy()
        params = _skip_last_mlp(model.params()) \
            if fault == "skip_last_mlp" else None
        used_mask = np.ones_like(mask) if fault == "mask_ignored" else mask
        got = model.pooled_logits(torch.from_numpy(ids),
                                  torch.from_numpy(used_mask),
                                  params=params).numpy()
    err = row_rel_err(got, ref)
    if fault == "none":
        assert err <= BERT_TOL
    elif fault == "mask_ignored":
        assert row_rel_err(got[1], ref[1]) > 10 * BERT_TOL
        assert row_rel_err(np.delete(got, 1, 0), np.delete(ref, 1, 0)) \
            <= BERT_TOL
    else:
        assert err > 10 * BERT_TOL


def test_bound_counts(full_width):
    """``operations`` is ``bert_encoder_flops`` a row; ``weight_bytes``
    every bf16 weight but the token table (about 171 MB)."""
    model = full_width[0]
    assert model.operations(1) == 22348431360
    assert model.operations(8) == 8 * 22348431360
    assert model.weight_bytes() == 171282432
    assert sum(t.numel() for t in tree_leaves(model.params())) \
        == 85641216 + tb.VOCAB * tb.D_MODEL


def _ids_vs_jax_gather(ids):
    table = np.arange(NARROW["VOCAB"], dtype=np.float32)[:, None]
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    got = torch.from_numpy(table)[tb.clamp_ids(
        torch.from_numpy(ids), NARROW["VOCAB"]).long()].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", ["negative", "beyond"])
def test_out_of_range_ids_equal_jax_clamped_gather(narrow, monkeypatch, bad):
    """An id below zero wraps once, then every id clamps into the table,
    as JAX's gather does: the clamp alone, then the whole encoder in
    float32 against JAX's."""
    v = NARROW["VOCAB"]
    if bad == "negative":
        wild = np.array([-1, -5, -v, -(v + 1), -10 ** 6], np.int32)
        assert tb.clamp_ids(torch.from_numpy(wild), v).tolist() == [
            v - 1, v - 5, 0, 0, 0]
    else:
        wild = np.array([v, v + 7, 5 * v, 30522, 10 ** 6], np.int32)
        assert tb.clamp_ids(torch.from_numpy(wild), v).tolist() == [v - 1] * 5
    _ids_vs_jax_gather(wild)
    ids, mask = _inputs(2, v, seed=4)
    ids[0, 3:3 + len(wild)] = wild
    ids[1, 1:1 + len(wild)] = wild
    jax_model, np_tree = _jax_model("float32")
    ref = _jax_forward(monkeypatch, jax_model, ids, mask, True)
    pre, _ = _port_outputs(_port_model(np_tree, "float32"), ids, mask)
    assert row_rel_err(pre, ref) <= F32_TOL


TEXTS = {
    "unicode": [b"Gr\xc3\xbc\xc3\x9fe aus K\xc3\xb6ln \xe2\x80\x94 na\xc3\xafve "
                b"\xe6\x97\xa5\xe6\x9c\xac\xe8\xaa\x9e CAF\xc3\x89", b"x"],
    "empty": [b"", b"   \t  "],
    "over_long": [" ".join("w{}".format(i) for i in range(300)).encode(),
                  b"short one"],
}


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("case", sorted(TEXTS))
def test_tokenizer_bitwise_equal_to_jax(case, batched):
    texts = TEXTS[case]
    arr = (np.array(texts, dtype=np.object_).reshape(-1, 1) if batched
           else np.array(texts[:1], dtype=np.object_))
    got = tb.BertTokenizerModel().execute({"TEXT": arr}, None)
    want = jb.BertTokenizerModel().execute({"TEXT": arr}, None)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype == np.int32
        assert got[name].shape == want[name].shape
        np.testing.assert_array_equal(got[name], want[name])
    ids = got["INPUT_IDS"].reshape(-1, tb.SEQ_LEN)
    if case == "over_long":
        assert ids[0, -1] == 102 and got["ATTENTION_MASK"].reshape(
            -1, tb.SEQ_LEN)[0].all()
    if case == "empty":
        assert ids[0, :3].tolist() == [101, 102, 0]


def _narrow_models():
    return [tb.BertTokenizerModel(),
            tb.BertEncoderModel(device="cpu", seed=3, dtype=torch.float32),
            tb.BertEnsembleModel()]


def test_ensemble_through_core_equals_encoder(narrow):
    """``bert_ensemble`` through the port's core equals ``bert_encoder``
    on ``bert_tokenizer``'s output, batched and as a 1-D request; the
    tokenizer is KIND_CPU, the ensemble's platform ``ensemble``."""
    core = InferenceServer(_narrow_models())
    try:
        core.warmup()
        texts = np.array([[b"the quick brown fox"], [b""],
                          [b"jumps over the lazy dog twice"]],
                         dtype=np.object_)
        for text in (texts, texts[0]):
            ens = core.infer(InferRequest("bert_ensemble", inputs={
                "TEXT": text})).outputs[0][1]
            tok = dict((spec["name"], arr) for spec, arr in core.infer(
                InferRequest("bert_tokenizer", inputs={"TEXT": text})
            ).outputs)
            enc = core.infer(InferRequest("bert_encoder", inputs=tok))
            np.testing.assert_array_equal(ens, enc.outputs[0][1])
            assert ens.shape == ((3, 64) if text.ndim == 2 else (64,))
        assert core.model_config("bert_tokenizer")["instance_group"][0][
            "kind"] == "KIND_CPU"
        assert core.model_config("bert_encoder")["instance_group"][0][
            "kind"] == "KIND_GPU"
        cfg = core.model_config("bert_ensemble")
        assert cfg["platform"] == "ensemble"
        assert [s["model_name"] for s in cfg["ensemble_scheduling"][
            "step"]] == ["bert_tokenizer", "bert_encoder"]
        assert "dynamic_batching" not in core.model_config("bert_encoder")
    finally:
        core.close()


def test_stream_infer_over_grpc_equals_unary(narrow):
    """Several texts on one ``ModelStreamInfer`` stream (each request runs
    in a thread of its own) through the port's gRPC front end, every
    answer equal to the same text's unary ``ModelInfer`` answer."""
    core = InferenceServer(_narrow_models())
    server = GrpcServer(core, port=0).start()
    client = grpcclient.InferenceServerClient(
        "127.0.0.1:{}".format(server.port))
    texts = ["bench {} alpha brown".format(i).encode() for i in range(8)]

    def text_input(text):
        inp = grpcclient.InferInput("TEXT", [1, 1], "BYTES")
        inp.set_data_from_numpy(np.array([[text]], dtype=np.object_))
        return inp

    try:
        unary = {i: client.infer("bert_ensemble", [text_input(t)]).as_numpy(
            "POOLED") for i, t in enumerate(texts)}
        got, errors = {}, []

        def on_result(result, error):
            if error is not None:
                errors.append(error)
            else:
                got[result.get_response().id] = result.as_numpy("POOLED")

        client.start_stream(callback=on_result)
        for i, text in enumerate(texts):
            client.async_stream_infer("bert_ensemble", [text_input(text)],
                                      request_id=str(i))
        client.stop_stream()
        assert not errors and len(got) == len(texts)
        for i in range(len(texts)):
            assert got[str(i)].shape == (1, 64)
            np.testing.assert_array_equal(got[str(i)], unary[i])
        assert not np.array_equal(unary[0], unary[1])
    finally:
        client.close()
        server.stop()
        core.close()


def test_init_params_follow_jax_distributions(narrow):
    drawn = tb.BertEncoderModel.init_params(torch.Generator().manual_seed(0),
                                            "cpu")
    _, np_tree = _jax_model("bfloat16")
    bridged = tb.BertEncoderModel.params_from_jax(np_tree, "cpu")

    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda t: (tuple(t.shape), t.dtype), tree,
            is_leaf=lambda t: isinstance(t, torch.Tensor))

    assert shapes(drawn) == shapes(bridged)
    w = drawn["layers"][0]["w_out"].float()
    assert abs(w.std().item() * np.sqrt(NARROW["D_FF"]) - 1) < 0.05
    assert drawn["layers"][1]["ln2"].eq(1).all()
    again = tb.BertEncoderModel.init_params(torch.Generator().manual_seed(0),
                                            "cpu")
    assert torch.equal(again["pool_w"], drawn["pool_w"])


def test_serve_models_bert_needs_a_card_unless_asked(monkeypatch):
    """``serve.py --models bert`` runs on the card: without one, and
    without ``--device cpu``, it raises before it builds a model."""
    from tpuserver_torch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--models", "bert", "--port", "0"])


def test_serve_models_bert_serves_the_ensemble():
    """``serve.py --models bert --device cpu`` as a process: the three
    models, and no llama, over HTTP; SIGINT stops it."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    import threading
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuserver_torch.serve", "--models", "bert",
         "--device", "cpu", "--port", str(port)],
        env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src", "python")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(240, proc.kill)
    watchdog.start()
    try:
        line = proc.stdout.readline()
        while line and "serving" not in line:
            line = proc.stdout.readline()
        assert "bert_ensemble" in line and "llama" not in line, line
        body = json.dumps({"inputs": [{"name": "TEXT", "datatype": "BYTES",
                                       "shape": [1, 1],
                                       "data": ["hello world"]}]})
        url = "http://127.0.0.1:{}/v2/models/bert_ensemble/infer".format(
            port)
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body.encode(), method="POST"), timeout=120) as r:
            out = json.loads(r.read())["outputs"][0]
        assert out["name"] == "POOLED" and out["shape"] == [1, tb.D_MODEL]
        assert np.isfinite(out["data"]).all()
        with urllib.request.urlopen("http://127.0.0.1:{}/v2/models/"
                                    "bert_tokenizer/config".format(port),
                                    timeout=60) as r:
            cfg = json.loads(r.read())
        assert cfg["instance_group"][0]["kind"] == "KIND_CPU"
    finally:
        watchdog.cancel()
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
