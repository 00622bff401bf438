"""Disaggregated prefill/decode over the port's replicas, held against
the JAX fleet tier: the JAX package's ``FleetRouter`` and its
``PhaseSplitOrchestrator`` in front of two port servers (one ``prefill``,
one ``decode``), and the phase-split legs on port cores beside the same
legs on JAX cores.

Float32 ``tiny``, weights bridged from ``llama.init_params(PRNGKey(0))``
(``params_from_jax``); tokens must equal the JAX fused run's exactly.
Both port servers live in this process: a CPU region's handle (the KV
export) attaches only in-process, so cross-process attach is proven on
the card (``chip_smoke.py`` phase 4g).  Every wait polls its condition
under a deadline of its own."""

import http.client
import json
import os
import sys

import numpy as np
import pytest

from tpuserver.core import InferenceServer as JaxServer
from tpuserver.core import InferRequest as JaxRequest
from tpuserver.disagg import PREFILL_LEG_ID_SUFFIX
from tpuserver.models.llama_serving import LlamaGenerateModel as JaxLlama
from tpuserver.router import FleetRouter
from tpuserver_torch import fault_points
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.errors import KvExportMissing
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models.llama_serving import LlamaGenerateModel

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_helpers import (  # noqa: E402,F401 (fixtures)
    WAIT_S, one_torch_thread, sse_events, tiny_cfgs, tparams, wait_for)

pytestmark = pytest.mark.torch_port

MAX_SEQ = 64
PROMPT = list(range(1, 21))
N_TOK = 10
STREAM_PATH = "/v2/models/llama_generate/generate_stream"


@pytest.fixture(autouse=True)
def _clean_faults():
    fault_points.clear()
    yield
    fault_points.clear()


def _jax_core(role=None):
    model = JaxLlama(cfg=tiny_cfgs()[0], max_seq=MAX_SEQ, max_slots=4)
    return JaxServer([model], role=role)


def _port_core(tparams, role=None, scope=None):
    model = LlamaGenerateModel(cfg=tiny_cfgs()[1], max_seq=MAX_SEQ,
                               max_slots=4, params=tparams, device="cpu",
                               fault_scope=scope)
    return InferenceServer([model], role=role, fault_scope=scope)


def _gen(core, prompt, max_tokens, params=None):
    cls = JaxRequest if isinstance(core, JaxServer) else InferRequest
    req = cls("llama_generate", inputs={
        "PROMPT_IDS": np.asarray(prompt, dtype=np.int32),
        "MAX_TOKENS": np.asarray([max_tokens], dtype=np.int32)},
        parameters=dict(params or {}))
    return [int(o[1][0]) for resp in core.infer_stream(req)
            for o in resp.outputs if o[0]["name"] == "TOKEN"]


@pytest.fixture(scope="module")
def fused():
    """The JAX fused run: every split and handoff must stream it."""
    core = _jax_core()
    try:
        return _gen(core, PROMPT, N_TOK)
    finally:
        core.close()


def _stream(router, gen_id):
    """One generation through the router: (tokens, seqs, final)."""
    host, _, port = router.url.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=WAIT_S)
    body = json.dumps({"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [len(PROMPT)],
         "data": PROMPT},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [N_TOK]}], "parameters": {"generation_id": gen_id}})
    try:
        conn.request("POST", STREAM_PATH, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, (resp.status, resp.read())
        tokens, seqs, final = [], [], False
        for seq, event in sse_events(resp):
            if event.get("final"):
                final = True
                break
            assert "error" not in event, event
            seqs.append(seq)
            tokens.append(event["outputs"][0]["data"][0])
        return tokens, seqs, final
    finally:
        conn.close()


class _Fleet:
    """Port servers (each a core behind its HttpServer) and the JAX
    ``FleetRouter`` over them."""

    def __init__(self, tparams, specs):
        self.cores, self.https = [], []
        for role, scope in specs:
            core = _port_core(tparams, role=role, scope=scope)
            self.cores.append(core)
            self.https.append(HttpServer(core, port=0).start())
        self.router = FleetRouter(
            ["127.0.0.1:{}".format(h.port) for h in self.https],
            probe_interval_s=0.1, gen_ttl_s=30.0).start()

    def eligible(self):
        return sum(r["eligible"] for r in self.router.stats()["replicas"])

    def close(self):
        self.router.stop()
        for http_server, core in zip(self.https, self.cores):
            http_server.stop()
            core.close()


@pytest.fixture
def fleet(tparams):
    made = []

    def make(specs):
        made.append(_Fleet(tparams, specs))
        return made[-1]

    yield make
    for f in made:
        f.close()


def test_router_splits_generation_across_port_prefill_and_decode(fleet,
                                                                  fused):
    """The JAX router's orchestrator sees a ``prefill`` and a ``decode``
    port replica in their snapshots and splits a generation: the prefill
    leg (under the ``~prefill`` leg id) on P exports its KV, the one-shot
    descriptor moves, and D attaches it: the stream equals the JAX fused
    run, gap-free, with one split and one transfer counted and one
    attach admission (and no prefill) on D."""
    f = fleet([("prefill", None), ("decode", None)])
    wait_for(lambda: f.eligible() == 2 and (
        f.router.stats()["disagg"]["prefill_replicas"],
        f.router.stats()["disagg"]["decode_replicas"]) == (1, 1),
        "both role pools")
    prefill, decode = f.cores
    tokens, seqs, final = _stream(f.router, "split-1")
    assert tokens == fused
    assert seqs == list(range(N_TOK)) and final
    disagg = f.router.stats()["disagg"]
    assert (disagg["splits"], disagg["transfers"]) == (1, 1)
    assert disagg["transfer_bytes"] > 0 and not disagg["fallbacks"]
    pstats = prefill.health_snapshot()["models"]["llama_generate"]
    dstats = decode.health_snapshot()["models"]["llama_generate"]
    assert (pstats["admitted"], pstats["tokens"]) == (1, 1)
    assert (dstats["attach_admissions"], dstats["prefix_misses"]) == (1, 0)
    assert dstats["tokens"] == N_TOK - 1
    # the leg's export was claimed (and is released or claimed-gone)
    with pytest.raises(Exception) as err:
        prefill.kv_export_descriptor("split-1" + PREFILL_LEG_ID_SUFFIX)
    assert err.value.code in (404, 409)


def _split_legs(prefill, decode, gid, stale):
    """test_disagg's A/B on one package's cores: prefill leg, descriptor,
    (with ``stale``, the export dropped between fetch and attach), decode
    leg; returns (token 0, descriptor position, the decode leg's
    tokens)."""
    tok0 = _gen(prefill, PROMPT, 1, {"generation_id": gid,
                                     "kv_phase": "prefill"})
    desc = prefill.kv_export_descriptor(gid)
    if stale:
        prefill.drop_kv_region(gid)
    rest = _gen(decode, PROMPT + tok0, N_TOK - 1,
                {"generation_id": gid + "-d", "kv_attach": desc})
    if not stale:
        prefill.drop_kv_region(gid)
    return tok0, desc["position"], rest


@pytest.mark.parametrize("stale", [False, True], ids=["attach", "stale"])
def test_phase_split_legs_match_jax_and_stale_descriptor_reprefills(
        tparams, fused, stale):
    """The legs of ``tests/test_disagg.py``'s A/B on port cores beside
    JAX cores: token 0, the descriptor's position and the decode leg's
    tokens equal JAX's and the fused run's.  A descriptor whose export
    was dropped between fetch and attach falls back to a fused
    re-prefill (a prefix miss, no attach) with the same tokens."""
    cores = {"jax": (_jax_core("prefill"), _jax_core("decode")),
             "port": (_port_core(tparams, "prefill"),
                      _port_core(tparams, "decode"))}
    try:
        out = {k: _split_legs(p, d, "ab-" + k, stale)
               for k, (p, d) in cores.items()}
        dstats = cores["port"][1].health_snapshot()["models"][
            "llama_generate"]
    finally:
        for pair in cores.values():
            for core in pair:
                core.close()
    assert out["port"] == out["jax"]
    tok0, position, rest = out["port"]
    assert tok0 + rest == fused and position == len(PROMPT) + 1
    if stale:
        assert dstats["attach_admissions"] == 0
        assert dstats["prefix_misses"] > 0
    else:
        assert (dstats["attach_admissions"], dstats["prefix_misses"]) == (
            1, 0)


def test_stale_descriptor_import_is_a_typed_404(tparams):
    """The import of a dropped export is the typed 404 the decode leg
    turns into a prefill, never a late failure."""
    prefill, decode = _port_core(tparams, "prefill"), _port_core(tparams)
    try:
        _gen(prefill, PROMPT, 1, {"generation_id": "gone",
                                  "kv_phase": "prefill"})
        desc = prefill.kv_export_descriptor("gone")
        prefill.drop_kv_region("gone")
        with pytest.raises(KvExportMissing) as err:
            decode.import_kv_descriptor(desc)
        assert err.value.code == 404
    finally:
        prefill.close()
        decode.close()


def test_serving_replica_death_hands_off_token_identically(fleet, fused):
    """Two fused port replicas behind the router; the serving replica's
    stream is severed after 3 events (the ``http.generate_stream`` fault
    point, armed once in each replica's scope, as JAX's router test does):
    the router re-admits prompt + history on the other, and the client's
    one stream equals the JAX fused run, gap-free."""
    f = fleet([(None, "dis-a"), (None, "dis-b")])
    wait_for(lambda: f.eligible() == 2, "both replicas eligible")
    for scope in ("dis-a", "dis-b"):
        fault_points.install("http.generate_stream", mode="raise", times=1,
                             skip=3, scope=scope)
    before = f.router.stats()["handoffs"]
    tokens, seqs, final = _stream(f.router, "handoff-1")
    assert tokens == fused
    assert seqs == list(range(N_TOK)) and final
    assert f.router.stats()["handoffs"] > before
    assert f.router.stats()["disagg"]["splits"] == 0  # no role pools
