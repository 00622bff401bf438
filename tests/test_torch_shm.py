"""The port's shared-memory data plane on the CPU (tpuserver_torch.
cuda_shared_memory with host regions, the core's shm and KV-export verbs,
the scheduler's KV hooks and the serving model's shm parameters), held
against the JAX package with XLA shared-memory regions
(``tritonclient.utils.xla_shared_memory``) on the same inputs and the
same weights (``init_params(PRNGKey(0))`` bridged by ``params_from_jax``),
float32 ``tiny``.

Tolerances: greedy tokens, ring offsets, event ``seq``s and export
positions must be identical; logprobs read back from a ring within 1e-4
(both sides compute in float32, in another order); an exported KV cache
within atol 1e-5 of JAX's export of the same generation.  Every wait
polls its condition under a deadline of its own (``_wait``), never a
fixed sleep."""

import base64
import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserver.core import InferenceServer as JaxServer
from tpuserver.core import InferRequest as JaxRequest
from tpuserver.core import ServerError as JaxError
from tpuserver.models import llama as jl
from tpuserver.models.llama_serving import LlamaGenerateModel as JaxLlama
from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch import shm_ring
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.errors import (
    BadRequest,
    KvExportClaimed,
    KvExportMissing,
    RegionPinned,
)
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tritonclient.utils import xla_shared_memory as xshm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# one torch thread per test process, as the port's other files with a
# live decode loop run: tiny steps stay short when workers share the cores
from torch_port_helpers import one_torch_thread  # noqa: E402,F401 (fixture)

pytestmark = pytest.mark.torch_port

VOCAB = 256
MAX_SEQ = 64
PROMPT = np.array([5, 3, 7, 1], dtype=np.int32)
MT = 6
WAIT_S = 60.0  # each wait's own deadline: generous under -n 6


def _cfgs():
    jcfg = dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32,
                               decode_impl="dense")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tparams():
    jcfg, _ = _cfgs()
    return tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), jcfg)), "cpu")


def _wait(predicate, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError("timed out after {} s waiting for {}".format(
        timeout, what))


class _LoopHold:
    """Holds a scheduler's decode loop inside one step call until a
    dropped stream's consumer has gone.  Without it a loop that runs
    ahead of a slow consumer (six busy test workers) can finish the
    generation before the drop, and a completed generation parks no
    export; with it the drop lands mid-generation at the same step in
    both packages, so the export's valid position is fixed too."""

    def __init__(self, fns):
        self._step = fns["step"]
        self._calls = 0
        self._hold_at = None
        self._released = threading.Event()
        self.reached = threading.Event()  # the loop is in the held call
        self.held_too_long = False
        fns["step"] = self._held_step  # the loop looks it up per call

    def _held_step(self, *args, **kwargs):
        if self._hold_at is not None:
            self._calls += 1
            if self._calls == self._hold_at:
                self.reached.set()
                self.held_too_long = not self._released.wait(WAIT_S)
        return self._step(*args, **kwargs)

    def arm(self, hold_at):
        """Hold the ``hold_at``-th step call from now (the loop is idle)."""
        self._calls = 0
        self._released.clear()
        self.reached.clear()
        self._hold_at = hold_at

    def release(self):
        self._hold_at = None
        self._released.set()


# -- the two packages behind one interface -----------------------------------


class _Side:
    """One package's core, model and region module, with the few verbs
    the tests drive on both: regions, streams and their events."""

    def __init__(self, jax_side, max_slots, tparams=None, **kwargs):
        jcfg, tcfg = _cfgs()
        self.jax = jax_side
        if jax_side:
            self.model = JaxLlama(cfg=jcfg, max_seq=MAX_SEQ,
                                  max_slots=max_slots, **kwargs)
            self.core = JaxServer([self.model])
        else:
            self.model = LlamaGenerateModel(
                cfg=tcfg, max_seq=MAX_SEQ, max_slots=max_slots,
                params=tparams, device="cpu", **kwargs)
            self.core = InferenceServer([self.model])
        self.handles = {}
        self._hold = None  # a _LoopHold, made by the first drop

    def region(self, name, byte_size=4096, values=None):
        if self.jax:
            h = xshm.create_shared_memory_region(name, byte_size)
            if values is not None:
                xshm.set_shared_memory_region(h, [jnp.asarray(values)])
            self.core.register_xla_shm(name, xshm.get_raw_handle(h), 0,
                                       byte_size)
        else:
            h = csm.create_shared_memory_region(name, byte_size,
                                                device="cpu")
            if values is not None:
                csm.set_shared_memory_region(h, [np.asarray(values)])
            self.core.register_cuda_shm(name, csm.get_raw_handle(h), 0,
                                        byte_size)
        self.handles[name] = h
        return h

    def read(self, name, datatype, offset):
        mod = xshm if self.jax else csm
        return mod.get_contents_as_numpy(self.handles[name], datatype, [1],
                                         offset)[0]

    def wipe(self, name, nbytes):
        mod = xshm if self.jax else csm
        mod.set_shared_memory_region(self.handles[name],
                                     [np.zeros(nbytes // 4, np.int32)])

    def shm_status(self):
        return (self.core.xla_shm_status() if self.jax
                else self.core.cuda_shm_status())

    def unregister(self, name=""):
        if self.jax:
            self.core.unregister_xla_shm(name)
        else:
            self.core.unregister_cuda_shm(name)

    def request(self, inputs, parameters):
        cls = JaxRequest if self.jax else InferRequest
        return cls("llama_generate", inputs=dict(inputs),
                   parameters=dict(parameters or {}))

    def events(self, inputs, parameters=None, take=None, before_close=None):
        """(token or None, response parameters) per event; the stream is
        closed after ``take`` events (once ``before_close()`` returned)."""
        out = []
        stream = self.core.infer_stream(self.request(inputs, parameters))
        for resp in stream:
            arrays = {o[0]["name"]: o[1] for o in resp.outputs}
            token = (int(np.asarray(arrays["TOKEN"])[0])
                     if "TOKEN" in arrays else None)
            out.append((token, dict(resp.parameters or {})))
            if take is not None and len(out) >= take:
                if before_close is not None:
                    before_close()
                stream.close()
                break
        return out

    def tokens(self, prompt=PROMPT, n=MT, parameters=None, take=None):
        return [t for t, _ in self.events(
            {"PROMPT_IDS": np.asarray(prompt, np.int32),
             "MAX_TOKENS": np.array([n], np.int32)}, parameters, take)]

    def hold(self):
        """This side's :class:`_LoopHold` on its decode loop (batched
        path), made on first use."""
        if self._hold is None:
            if self.jax:
                self.model._ensure_compiled()
                fns = self.model._scheduler._fns
            else:
                fns = self.model._ensure_scheduler()._fns
            self._hold = _LoopHold(fns)
        return self._hold

    def dropped(self, n, parameters, take):
        """The first ``take`` tokens of a generation of ``n`` whose
        consumer then drops it.  The drop lands while the loop is held in
        its ``take + 3``-th step call (by then at least ``take + 1``
        tokens have come back, through the one-deep pipeline, and ``n``
        is beyond reach), so the generation is cancelled at the same step
        however the threads are scheduled."""
        assert n > take + 4
        hold = self.hold()
        hold.arm(take + 3)
        try:
            return [t for t, _ in self.events(
                {"PROMPT_IDS": PROMPT, "MAX_TOKENS": np.array([n], np.int32)},
                parameters, take, before_close=lambda: _wait(
                    hold.reached.is_set, "the loop to reach its hold"))]
        finally:
            hold.release()
            assert not hold.held_too_long

    def prompt_view(self, name="plane"):
        return self.core.read_shm_input(name, PROMPT.nbytes, 0, "INT32",
                                        [len(PROMPT)])

    def stats(self):
        return self.model.scheduler_stats() or {}

    def close(self):
        self.core.close()
        for name, h in self.handles.items():
            if name in self.shm_status():
                self.unregister(name)
            if self.jax:
                xshm.destroy_shared_memory_region(h)
            else:
                csm.destroy_shared_memory_region(h)


@pytest.fixture
def sides(tparams):
    """``make(max_slots)`` -> (JAX side, port side), closed at teardown."""
    made = []

    def make(max_slots=2, **kwargs):
        pair = (_Side(True, max_slots, **kwargs),
                _Side(False, max_slots, tparams, **kwargs))
        made.extend(pair)
        return pair

    yield make
    for side in made:
        side.close()


def _both(make, fn, max_slots=2):
    """``fn(side)`` on the JAX side and the port side; both results."""
    return [fn(side) for side in make(max_slots)]


# -- the region module and the shm prompt ------------------------------------


def test_cpu_region_module_round_trip():
    """create / raw handle / in-process attach (an alias: same memory) /
    set / get as numpy and as a tensor view / destroy, on a CPU region;
    the raw handle is 64 bytes in base64, like a cudaIpcMemHandle_t."""
    h = csm.create_shared_memory_region("mod", 256, device="cpu")
    try:
        raw = csm.get_raw_handle(h)
        assert len(base64.b64decode(raw)) == csm.HANDLE_BYTES
        assert h in csm.allocated_shared_memory_regions()
        csm.set_shared_memory_region(h, [np.arange(4, dtype=np.int32),
                                         np.array([2.5], np.float32)], 8)
        attached = csm.attach_from_raw_handle(raw, 64)
        assert attached.tensor.data_ptr() == h.tensor.data_ptr()
        assert csm.get_contents_as_numpy(attached, "INT32", [4], 8).tolist() \
            == [0, 1, 2, 3]
        view = csm.get_contents_as_tensor(h, np.float32, [1], 24)
        assert view.item() == 2.5
        assert view.data_ptr() == h.tensor.data_ptr() + 24
        with pytest.raises(csm.CudaSharedMemoryException, match="exceed"):
            csm.get_contents_as_tensor(attached, "INT32", [4], 64)
    finally:
        csm.destroy_shared_memory_region(h)
    assert h not in csm.allocated_shared_memory_regions()
    with pytest.raises(csm.RegionGone):
        csm.attach_from_raw_handle(raw)


def test_cpu_region_handle_from_another_process_is_refused():
    """A CPU region's handle attaches only in its own process: another
    process gets the typed refusal (the core answers it with a 400)."""
    h = csm.create_shared_memory_region("foreign", 64, device="cpu")
    try:
        code = ("import sys; from tpuserver_torch import cuda_shared_memory "
                "as c\ntry:\n    c.attach_from_raw_handle(sys.argv[1])\n"
                "except c.CudaSharedMemoryException as e:\n"
                "    print('refused:', e)\n")
        out = subprocess.run(
            [sys.executable, "-c", code, csm.get_raw_handle(h).decode()],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "src", "python")))
        assert out.returncode == 0 and "refused:" in out.stdout, out.stdout
    finally:
        csm.destroy_shared_memory_region(h)
    core = InferenceServer()
    with pytest.raises(BadRequest, match="unable to attach") as err:
        core.register_cuda_shm("x", csm.get_raw_handle(h), 0, 64)
    assert err.value.code == 400


@pytest.mark.parametrize("max_slots", [1, 2])
def test_shm_prompt_tokens_equal_inband_in_both_packages(sides, max_slots):
    """A prompt read by shm reference streams the in-band tokens, on both
    paths, in both packages; the port's view is the region's memory at
    the offset (no copy)."""
    def run(side):
        h = side.region("plane", values=PROMPT)
        inband = side.tokens()
        view = side.prompt_view()
        if not side.jax:
            assert isinstance(view, torch.Tensor)
            assert view.data_ptr() == h.tensor.data_ptr()
            off = side.core.read_shm_input("plane", 8, 8, "INT32", [2])
            assert off.data_ptr() == h.tensor.data_ptr() + 8
            assert side.core.shm_stats()["shm_zero_copy_reads"] == 2
        shm = [t for t, _ in side.events({"PROMPT_IDS": view,
                                          "MAX_TOKENS": np.array([MT])})]
        return inband, shm

    (j_in, j_shm), (t_in, t_shm) = _both(sides, run, max_slots)
    assert t_in == t_shm == j_in == j_shm and len(t_in) == MT


def test_system_shm_prompt_and_ring_match_jax(sides):
    """A POSIX (system) region registered with both cores: the prompt read
    from it (a numpy array: system memory is the host's) streams the
    in-band tokens, a ring in it holds them, and a read past it is a
    typed 400, as in JAX."""
    from tritonclient.utils import shared_memory as sysshm

    key = "/tt_port_sys_{}".format(os.getpid())
    handle = sysshm.create_shared_memory_region("sys", key, 4096)
    try:
        def run(side):
            sysshm.set_shared_memory_region(handle, [PROMPT])
            side.core.register_system_shm("sys", key, 0, 4096)
            view = side.core.read_shm_input("sys", PROMPT.nbytes, 0,
                                            "INT32", [len(PROMPT)])
            events = side.events(
                {"PROMPT_IDS": view, "MAX_TOKENS": np.array([MT])},
                {"shm_ring_region": "sys", "shm_ring_slots": 8,
                 "shm_ring_offset": 64, "generation_id": "s"})
            ring = sysshm.get_contents_as_numpy(
                handle, np.int32, [MT, 2], 64)[:, 0].tolist()
            with pytest.raises((JaxError, BadRequest)) as err:
                side.core.read_shm_input("sys", 8, 4092, "INT32", [2])
            side.core.unregister_system_shm("sys")
            return (type(view).__name__, side.tokens(), events, ring,
                    err.value.code, side.core.system_shm_status())

        j, t = _both(sides, run)
        assert t[0] == "ndarray"
        assert t[1] == j[1] == t[3] == j[3]
        assert [p for _, p in t[2]] == [p for _, p in j[2]]
        assert t[4:] == j[4:] == (400, {})
    finally:
        sysshm.destroy_shared_memory_region(handle)


def test_write_shm_output_matches_jax(sides):
    """``write_shm_output`` lands an array's bytes at the offset, bounds
    checked, as JAX's does; a tensor goes into the region device to
    device."""
    out = np.arange(6, dtype=np.float32) * 0.5

    def run(side):
        side.region("out", byte_size=64)
        side.core.write_shm_output("out", 8, out, "FP32")
        with pytest.raises((JaxError, BadRequest)) as err:
            side.core.write_shm_output("out", 48, out, "FP32")
        mod = xshm if side.jax else csm
        return (mod.get_contents_as_numpy(side.handles["out"], "FP32", [6],
                                          8).tolist(), err.value.code)

    j, t = _both(sides, run)
    assert t == j == (out.tolist(), 400)
    _, tside = sides(2)
    tside.region("out", byte_size=64)
    tside.core.write_shm_output("out", 16, torch.full((2,), 7, dtype=torch.int32),
                                "INT32")
    assert csm.get_contents_as_numpy(tside.handles["out"], "INT32", [2],
                                     16).tolist() == [7, 7]


def test_model_kv_export_default_parks_without_the_parameter(sides):
    """The model's ``kv_export`` (``serve.py --kv-export``) is the default
    of ``kv_park``: a dropped stream exports with no parameter, and
    ``kv_park=False`` opts one out, as in JAX."""
    def run(side):
        side.dropped(8, {"generation_id": "d"}, take=3)
        _wait(lambda: "kvexport/d" in side.shm_status(), "the export")
        side.dropped(8, {"generation_id": "o", "kv_park": False}, take=3)
        _wait(lambda: side.stats().get("replay_entries", 0) >= 2,
              "the opted-out stream to park")
        return sorted(side.shm_status())

    assert _both(lambda n: sides(n, kv_export=True), run) == [
        ["kvexport/d"]] * 2


# -- the token ring ----------------------------------------------------------


def _ring_run(side, parameters, n_slots, base):
    side.region("plane", values=PROMPT)
    events = side.events({"PROMPT_IDS": side.prompt_view(),
                          "MAX_TOKENS": np.array([MT], np.int32)},
                         parameters)
    ring = [(int(side.read("plane", "INT32", base + 8 * (s % n_slots))),
             float(side.read("plane", "FP32", base + 8 * (s % n_slots) + 4)))
            for s in range(len(events))]
    return events, ring


@pytest.mark.parametrize("max_slots", [1, 2])
def test_token_ring_matches_jax(sides, max_slots):
    """Descriptor-only events (``seq``, ``shm_ring_offset``, and on the
    batched path the ``generation_id``), no tensors; the ring slots hold
    JAX's tokens, and its logprobs within 1e-4."""
    params = {"shm_ring_region": "plane", "shm_ring_slots": 8,
              "shm_ring_offset": 64, "generation_id": "g"}
    (j_ev, j_ring), (t_ev, t_ring) = _both(
        sides, lambda s: _ring_run(s, params, 8, 64), max_slots)
    assert [t for t, _ in t_ev] == [None] * MT
    assert [p for _, p in t_ev] == [p for _, p in j_ev]
    assert [p["shm_ring_offset"] for _, p in t_ev] == [
        64 + 8 * s for s in range(MT)]
    assert [t for t, _ in t_ring] == [t for t, _ in j_ring]
    np.testing.assert_allclose([lp for _, lp in t_ring],
                               [lp for _, lp in j_ring], atol=1e-4)


def test_ring_wraps_and_resume_rewrites_slots(sides):
    """A ring smaller than the generation wraps (slot = seq % slots); a
    resumed (completed) generation writes its replayed slots again with
    its seq numbering kept.  Both as JAX."""
    params = {"shm_ring_region": "plane", "shm_ring_slots": 4,
              "generation_id": "g"}

    def run(side):
        events, ring = _ring_run(side, params, 4, 0)
        side.wipe("plane", 64)
        replay = side.events(
            {"PROMPT_IDS": PROMPT, "MAX_TOKENS": np.array([MT], np.int32)},
            dict(params, resume_generation_id="g", resume_from_seq=0))
        rewritten = [int(side.read("plane", "INT32", (s % 4) * 8))
                     for s in (4, 5, 2, 3)]
        return events, ring, replay, rewritten

    j, t = _both(sides, run)
    assert [p["shm_ring_offset"] for _, p in t[0]] == [
        (s % 4) * 8 for s in range(MT)]
    assert [p for _, p in t[0]] == [p for _, p in j[0]]
    assert [x for x, _ in t[1]] == [x for x, _ in j[1]]
    assert [p for _, p in t[2]] == [p for _, p in j[2]]
    assert [p["seq"] for _, p in t[2]] == list(range(MT))
    assert t[3] == j[3]


def test_seq_guarded_ring_and_torn_fallback(sides):
    """``shm_ring_seq_base``: every slot's seq word reads its commit word
    after its event, the events carry the in-band tokens too, and a
    reader that finds a torn word falls back to them and counts it."""
    params = {"shm_ring_region": "plane", "shm_ring_slots": 8,
              "shm_ring_offset": 64, "shm_ring_seq_base": 512,
              "generation_id": "g"}
    jside, tside = sides(2)
    runs = []
    for side in (jside, tside):
        events, ring = _ring_run(side, params, 8, 64)
        words = [int(side.read("plane", "INT32",
                               shm_ring.seq_word_offset(s, 8, 512)))
                 for s in range(len(events))]
        runs.append((events, ring, words))
    (j_ev, _, j_words), (t_ev, t_ring, t_words) = runs
    inband = [t for t, _ in t_ev]
    assert inband == [t for t, _ in j_ev] == [t for t, _ in t_ring]
    assert [p for _, p in t_ev] == [p for _, p in j_ev]
    assert t_words == j_words == [shm_ring.commit_word(s)
                                  for s in range(MT)]
    # slot 3's word back to its in-progress marker, as a reader racing
    # the writer would find it
    tside.core.write_shm_ring_seq_word(
        "plane", shm_ring.seq_word_offset(3, 8, 512),
        shm_ring.begin_word(3))
    before, got = shm_ring.torn_total(), []
    for seq, (token, p) in enumerate(t_ev):
        word = int(tside.read("plane", "INT32",
                              shm_ring.seq_word_offset(seq, 8, 512)))
        if shm_ring.slot_committed(word, seq):
            got.append(int(tside.read("plane", "INT32",
                                      p["shm_ring_offset"])))
        else:
            shm_ring.note_torn()
            got.append(token)
    assert got == inband and shm_ring.torn_total() == before + 1


def test_seq_word_encoding_matches_jax():
    """The port's copy of the seqlock module computes JAX's words."""
    from tpuserver import shm_ring as jring

    for seq in (0, 1, 7, 10 ** 6, 2 ** 31):
        for fn in ("begin_word", "commit_word"):
            assert getattr(shm_ring, fn)(seq) == getattr(jring, fn)(seq)
        assert shm_ring.pack_word(shm_ring.commit_word(seq)) == \
            jring.pack_word(jring.commit_word(seq))
        assert not shm_ring.slot_committed(0, seq)
        assert not shm_ring.slot_committed(shm_ring.begin_word(seq), seq)
    assert shm_ring.seq_word_offset(10, 8, 512) == \
        jring.seq_word_offset(10, 8, 512) == 520


@pytest.mark.parametrize("max_slots", [1, 2])
def test_ring_write_past_the_region_is_a_typed_400(sides, max_slots):
    """A ring whose slot 4 lies past a 64-byte region fails that step
    with a typed 400, in both packages."""
    def run(side):
        side.region("plane", byte_size=64)
        with pytest.raises((JaxError, BadRequest)) as err:
            side.tokens(parameters={"shm_ring_region": "plane",
                                    "shm_ring_slots": 16,
                                    "shm_ring_offset": 32})
        return err.value.code, "out of bounds" in str(err.value)

    assert _both(sides, run, max_slots) == [(400, True)] * 2


def test_unregister_pinned_region_is_409_and_xla_is_400(sides):
    """A region a live stream's ring references cannot be unregistered
    (typed 409, the region stays, the stream is unharmed), nor can all
    regions; after the stream it can.  The port refuses XLA regions with
    a typed 400."""
    def run(side):
        side.region("plane")
        stream = side.core.infer_stream(side.request(
            {"PROMPT_IDS": PROMPT, "MAX_TOKENS": np.array([12], np.int32)},
            {"shm_ring_region": "plane", "shm_ring_slots": 16}))
        first = next(stream)
        codes = []
        for name in ("plane", ""):
            try:
                side.unregister(name)
            except (JaxError, RegionPinned) as e:
                codes.append(e.code)
        still = "plane" in side.shm_status()
        rest = list(stream)
        side.unregister("plane")
        return (first.parameters["shm_ring_offset"], codes, still,
                len(rest), side.shm_status())

    assert _both(sides, run) == [(0, [409, 409], True, 11, {})] * 2
    _, t = sides(2)
    with pytest.raises(BadRequest, match="no XLA device") as err:
        t.core.register_xla_shm("x", b"", 0, 64)
    assert err.value.code == 400


# -- park, export, attach ----------------------------------------------------


def _attach_runs(side):
    """The reference run, and a ``kv_park`` generation dropped after 4
    events and resumed from seq 4, with ``kv_park`` False (re-prefill)
    and True (attach); the prefix misses and attach counter around the
    attach resume."""
    out = {"reference": side.tokens(n=10)}
    for mode, park in (("reprefill", False), ("attach", True)):
        gid = "g-" + mode
        head = side.dropped(10, {"generation_id": gid, "kv_park": park},
                            take=4)
        _wait(lambda: side.stats().get("replay_entries", 0) >= (
            1 if mode == "reprefill" else 2) and (
            not park or "kvexport/" + gid in side.shm_status()),
            "the dropped stream to park")
        before = side.stats()
        tail = side.tokens(n=10, parameters={"resume_generation_id": gid,
                                             "resume_from_seq": 4})
        after = side.stats()
        out[mode] = head + tail
        out[mode + "_misses"] = after["prefix_misses"] - before[
            "prefix_misses"]
        out[mode + "_attach"] = (after.get("attach_admissions", 0)
                                 - before.get("attach_admissions", 0))
        out[mode + "_exports"] = sorted(side.shm_status())
    return out


def test_attach_equals_reprefill_equals_uninterrupted(sides):
    """A parked generation resumed over its KV export streams exactly the
    tokens of the re-prefill resume and of the uninterrupted run, in
    both packages and across them; the attach prefilled nothing
    (``prefix_misses`` unchanged), counted one attach admission, and
    consumed the export."""
    j, t = _both(sides, _attach_runs)
    assert t["attach"] == t["reprefill"] == t["reference"]
    assert j["attach"] == j["reprefill"] == j["reference"] == t["reference"]
    assert t["attach_misses"] == j["attach_misses"] == 0
    assert t["reprefill_misses"] > 0
    assert (t["attach_attach"], t["reprefill_attach"]) == (1, 0)
    assert t["attach_exports"] == j["attach_exports"] == []


def _park_export(side, gid="g", take=3, n=8):
    side.dropped(n, {"generation_id": gid, "kv_park": True}, take)
    _wait(lambda: "kvexport/" + gid in side.shm_status(),
          "the export of " + gid)


def test_exported_cache_matches_jax_export(sides):
    """The export of a generation dropped after 3 events holds JAX's
    export of the same generation over the valid prefix (atol 1e-5), at
    the same valid position, with its shape."""
    jside, tside = sides(2)
    for side in (jside, tside):
        _park_export(side)
    j_pos = jside.core._kv_exports["g"][1]
    t_pos = tside.core._kv_exports["g"][1]
    assert t_pos == j_pos and t_pos >= len(PROMPT) + 3
    j_cache = np.asarray(jside.core.import_kv_region("g")[0])
    t_cache, t_pos2 = tside.core.import_kv_region("g")
    assert t_pos2 == t_pos and tuple(t_cache.shape) == j_cache.shape
    np.testing.assert_allclose(t_cache[:, :, :, :t_pos].numpy(),
                               j_cache[:, :, :, :t_pos], atol=1e-5)


def _lifecycle(side):
    """Export names after: a park; a reused id; a second park; close."""
    seen = []
    _park_export(side, "g")
    seen.append(sorted(side.shm_status()))
    side.tokens(n=8, parameters={"generation_id": "g"})
    seen.append(sorted(side.shm_status()))
    _park_export(side, "g2")
    seen.append(sorted(side.shm_status()))
    side.core.close()
    seen.append(sorted(side.shm_status()))
    return seen


def test_export_lifecycle_never_leaks(sides):
    """A reused generation id supersedes the park and its export, and
    closing the server drops every export, as in JAX; every wait is on
    its own condition and deadline."""
    j, t = _both(sides, _lifecycle)
    assert t == j == [["kvexport/g"], [], ["kvexport/g2"], []]
    _, t = sides(2)
    assert t.core.shm_stats()["kv_exports_made"] == 0


def test_replay_expiry_drops_the_export(sides, monkeypatch):
    """An export lives as long as its replay entry: once the entry
    expires, the supervisor's sweep frees it (JAX's sweep does the
    same)."""
    from tpuserver_torch import scheduler as sched_mod

    _, t = sides(2)
    real = sched_mod.DecodeScheduler.__init__

    def short_ttl(self, *args, **kwargs):
        kwargs["replay_ttl_s"] = 0.5
        real(self, *args, **kwargs)

    monkeypatch.setattr(sched_mod.DecodeScheduler, "__init__", short_ttl)
    _park_export(t, "old")
    _wait(lambda: "kvexport/old" not in t.shm_status(),
          "the expired export to drop")
    stats = t.core.shm_stats()
    assert (stats["kv_exports_made"], stats["kv_exports_dropped"]) == (1, 1)
    assert t.stats()["replay_entries"] == 0


def test_descriptor_is_one_shot_and_inprocess_attach_decodes_fused(sides):
    """The prefill leg (``kv_phase=prefill``) exports prompt + its token;
    the descriptor's first fetch gives JAX's position, a second is a
    typed 409, a fetch after release a typed 404; a decode leg given the
    descriptor (``kv_attach``, on another core in this process) streams
    the fused run's tokens without a prefill, and one whose export was
    released falls back to the prefill with the same tokens."""
    def run(side):
        fused = side.tokens(n=10)
        tok0 = side.tokens(n=1, parameters={"generation_id": "leg",
                                            "kv_phase": "prefill"})
        desc = side.core.kv_export_descriptor("leg")
        with pytest.raises((JaxError, KvExportClaimed)) as err:
            side.core.kv_export_descriptor("leg")
        return fused, tok0, desc, err.value.code

    jside, tside = sides(2)
    (jf, jt0, jdesc, jcode), (tf, tt0, tdesc, tcode) = (run(jside),
                                                        run(tside))
    assert tt0 == jt0 == tf[:1] and tf == jf
    assert tdesc["position"] == jdesc["position"] == len(PROMPT) + 1
    assert tcode == jcode == 409
    _, decode = sides(2)
    rest = decode.tokens(list(PROMPT) + tt0, 9,
                         {"generation_id": "leg-d", "kv_attach": tdesc})
    stats = decode.stats()
    assert tt0 + rest == tf
    assert (stats["prefix_misses"], stats["attach_admissions"]) == (0, 1)
    tside.core.drop_kv_region("leg")  # the release
    with pytest.raises(KvExportMissing) as err:
        tside.core.kv_export_descriptor("leg")
    assert err.value.code == 404
    stale = decode.tokens(list(PROMPT) + tt0, 9,
                          {"generation_id": "leg-s",
                           "kv_attach": json.dumps(tdesc)})
    assert tt0 + stale == tf
    stats = decode.stats()
    assert stats["attach_admissions"] == 1 and stats["prefix_misses"] > 0


def _park_resume(side):
    """A 4-token generation parked in ``kv_cache_region``, then 3 more
    tokens resumed from it at position len(PROMPT) + 4."""
    side.region("park", byte_size=1 << 20)
    first = side.tokens(n=4, parameters={"kv_cache_region": "park"})
    second = side.tokens(np.array(first[-1:], np.int32), 3, {
        "kv_cache_region": "park", "kv_cache_resume": True,
        "kv_cache_position": len(PROMPT) + 4})
    return first, second


def test_kv_cache_region_park_and_resume_matches_jax(sides):
    """``kv_cache_region`` parks the finished cache in a client region and
    ``kv_cache_resume`` continues from it without a prefill: the
    single-stream and the batched paths stream JAX's tokens (the batched
    path parks in the single-stream shape, so either resumes either)."""
    single = _both(sides, _park_resume, max_slots=1)
    batched = _both(sides, _park_resume, max_slots=2)
    assert single[1] == single[0] == batched[0] == batched[1]
    assert len(single[1][0]) == 4 and len(single[1][1]) == 3


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_http_shm_prompt_ring_and_kvexport_routes(sides):
    """One HTTP round trip: a CUDA-shm region registered with Triton's
    body (``raw_handle.b64``), ``/generate_stream`` with PROMPT_IDS by
    reference and ring descriptor events (no tensors), the ring holding
    the in-band tokens; the region's status, a 409 unregister while a
    stream pins it and a 200 after; the ``/v2/kvexport`` routes (200,
    409, release, 404); the XLA registration's typed 400."""
    _, t = sides(2)
    srv = HttpServer(t.core, port=0).start()
    try:
        baseline = t.tokens()
        h = csm.create_shared_memory_region("plane", 4096, device="cpu")
        t.handles["plane"] = h
        csm.set_shared_memory_region(h, [PROMPT])
        status, _ = _http(srv.port, "POST",
                          "/v2/cudasharedmemory/region/plane/register",
                          {"raw_handle": {"b64": csm.get_raw_handle(
                              h).decode()}, "device_id": 0,
                           "byte_size": 4096})
        assert status == 200
        status, body = _http(srv.port, "GET",
                             "/v2/cudasharedmemory/status")
        assert json.loads(body)["plane"]["byte_size"] == 4096
        req = {"inputs": [
            {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [4],
             "parameters": {"shared_memory_region": "plane",
                            "shared_memory_byte_size": 16,
                            "shared_memory_offset": 0}},
            {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
             "data": [MT]}],
            "parameters": {"shm_ring_region": "plane", "shm_ring_slots": 8,
                           "shm_ring_offset": 128, "generation_id": "h",
                           "kv_park": True}}
        # the loop is held in its third step call (a token is out) until
        # the unregister was tried: the stream is still live then
        hold = t.hold()
        hold.arm(3)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/v2/models/llama_generate/generate_stream",
                     json.dumps(req))
        resp = conn.getresponse()
        assert resp.status == 200
        events, unregister_codes = [], []
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            event = json.loads(line[len("data: "):])
            if event.get("final"):
                break
            events.append(event)
            if len(events) == 1:
                unregister_codes.append(_http(
                    srv.port, "POST",
                    "/v2/cudasharedmemory/region/plane/unregister")[0])
                hold.release()
        conn.close()
        assert unregister_codes == [409] and not hold.held_too_long
        assert [e["outputs"] for e in events] == [[]] * MT
        offs = [e["parameters"]["shm_ring_offset"] for e in events]
        assert offs == [128 + 8 * i for i in range(MT)]
        assert [int(t.read("plane", "INT32", o)) for o in offs] == baseline
        assert _http(srv.port, "POST",
                     "/v2/cudasharedmemory/region/plane/unregister")[0] \
            == 200
        # the kvexport routes over a prefill leg's export
        t.tokens(n=1, parameters={"generation_id": "leg",
                                  "kv_phase": "prefill"})
        status, body = _http(srv.port, "GET", "/v2/kvexport/leg")
        assert status == 200 and json.loads(body)["position"] == 5
        assert _http(srv.port, "GET", "/v2/kvexport/leg")[0] == 409
        assert _http(srv.port, "POST", "/v2/kvexport/leg/release")[0] == 200
        assert _http(srv.port, "POST", "/v2/kvexport/leg/release")[0] == 200
        assert _http(srv.port, "GET", "/v2/kvexport/leg")[0] == 404
        status, body = _http(srv.port, "POST",
                             "/v2/xlasharedmemory/region/x/register",
                             {"raw_handle": {"b64": ""},
                              "byte_size": 64})
        assert status == 400 and b"no XLA device" in body
    finally:
        srv.stop()
