"""``python -m tpuserver_torch.bench_full`` and ``python -m
tpuserver_torch.bench`` on the CPU, over the port's own sockets.

Configs 1, 4 and 5 run as the CLI (``--quick --device cpu --llama-config
tiny``: ``simple``, the full-width BERT ensemble, the bf16 ``tiny``
llama); configs 2 and 3 run in-process on a core of narrow float32
vision models (the zoo's names and shapes, a fraction of the width) with
CPU "cuda" regions, which the server attaches in-process.  Every row's
keys are checked against the JAX bench's own: ``bench_full.py`` is read
as source (its ``_emit`` calls and summary lines), never imported, since
it imports JAX and XLA regions at the top."""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuserver_torch import bench_full
from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.models import default_models
from tpuserver_torch.models import vision as tv
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each kind of the port's rows, and the JAX function whose lines it copies
JAX_FUNCTION = {
    "simple_http": "bench_simple_http",
    "vision": "bench_vision",
    "vision_cuda_shm": "bench_vision_xla_shm",
    "vision_concurrent": "bench_vision_concurrent",
    "vision_concurrent_best": "bench_vision_concurrent",
    "bert_stream": "_bench_bert_stream_once",
    "bert_bound": "_bench_bert_stream_once",
    "llama_prefill": "bench_llama_direct",
    "llama_decode": "bench_llama_direct",
    "llama_stream": "bench_llama_stream",
    "llama_multistream": "bench_llama_multistream",
    "llama_scaling": "bench_llama_multistream",
    "core_inband": "bench_vision_core",
    "core_cuda_shm": "bench_vision_core",
    "core_ratio": "bench_vision_core",
}


def _jax_row_keys():
    """{JAX function: [key set of each line it prints]}, from the source
    of the repo's ``bench_full.py``: an ``_emit`` call's keys are the five
    it always writes and its keywords; a printed dict literal's are its
    own."""
    with open(os.path.join(REPO, "bench_full.py")) as f:
        tree = ast.parse(f.read())
    base = {"config", "metric", "value", "unit", "vs_baseline"}
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = getattr(node.func, "id", None)
            if name == "_emit":
                keys = base | {k.arg for k in node.keywords}
            elif (getattr(node.func, "attr", None) == "dumps" and node.args
                  and isinstance(node.args[0], ast.Dict)
                  and any(getattr(k, "value", None) == "metric"
                          for k in node.args[0].keys)):
                keys = {k.value for k in node.args[0].keys}
            else:
                continue
            out.setdefault(fn.name, []).append(frozenset(keys))
    return out


def test_row_keys_are_the_jax_bench_lines():
    """Each kind's pinned keys are one of the lines its JAX function
    prints, and every line of the JAX bench has a kind."""
    jax_keys = _jax_row_keys()
    for kind, keys in bench_full.ROW_KEYS.items():
        assert keys in jax_keys[JAX_FUNCTION[kind]], kind
    covered = {(JAX_FUNCTION[k], keys)
               for k, keys in bench_full.ROW_KEYS.items()}
    for fn, lines in jax_keys.items():
        for keys in lines:
            assert (fn, keys) in covered, (fn, sorted(keys))


def _rows(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith('{"config"')]


def _check_keys(rows):
    for row in rows:
        kind = bench_full.row_kind(row["metric"])
        assert kind is not None, row["metric"]
        assert set(row) == bench_full.ROW_KEYS[kind], row["metric"]
    return {bench_full.row_kind(r["metric"]) for r in rows}


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src", "python"),
                CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")


def test_configs_1_4_5_over_the_sockets_keys_equal_jax():
    """The CLI at ``--quick --device cpu --llama-config tiny``: config 1
    over HTTP (its answers checked first), 4 and 5 over gRPC, the
    continuous-batching rows at ``--llama-slots 4``; exit 0, no error
    line, every row with its JAX keys, every kind of those configs
    printed."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpuserver_torch.bench_full", "--quick",
         "--device", "cpu", "--llama-config", "tiny", "--configs", "1,4,5",
         "--llama-slots", "4"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"error"' not in proc.stderr, proc.stderr
    rows = _rows(proc.stdout)
    assert _check_keys(rows) == {
        "simple_http", "bert_stream", "bert_bound", "llama_prefill",
        "llama_decode", "llama_stream", "llama_multistream",
        "llama_scaling"}
    by_metric = {r["metric"]: r for r in rows}
    # whether 0.5 s windows settle depends on the host's load: the row
    # carries the verdict, either way
    assert isinstance(by_metric["simple_http_sync_conc1"]["stable"], bool)
    assert by_metric["tiny_prefill_T256"]["attn"] == "kernel"
    assert by_metric["llama_decoupled_stream"]["max_tokens"] == 16
    assert [r["streams"] for r in rows
            if r["metric"].startswith("llama_multistream_conc")] == [1, 4]
    assert all(r["value"] > 0 for r in rows)


class NarrowResNet(tv.ResNet50Model):
    _STAGES = (1, 1, 1, 1)
    _WIDTHS = (32, 64, 128, 256)
    max_batch_size = 8


class NarrowDenseNet(tv.DenseNet121Model):
    _BLOCKS = (1, 1, 1, 1)
    _GROWTH = 8
    max_batch_size = 8


def test_vision_configs_over_cpu_regions_fence_and_verify():
    """Configs 2 and 3 on narrow models through ``main(argv, core=)``:
    every CUDA-region row passed ``_fence_and_verify``, each of its
    requests was a zero-copy read, and no region is left registered or
    allocated."""
    core = InferenceServer(default_models() + [
        NarrowResNet(device="cpu", dtype=torch.float32),
        NarrowDenseNet(device="cpu", dtype=torch.float32)])
    core.warmup()
    reads0 = core.shm_stats()["shm_zero_copy_reads"]
    dispatches0 = bench_full.bench_vision_cuda_shm.dispatches
    keys0 = len(bench_full._vision_call_system_shm.keys)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench_full.main(["--quick", "--device", "cpu", "--configs",
                                  "2,3", "--window-s", "0.2"], core=core)
        reads = core.shm_stats()["shm_zero_copy_reads"] - reads0
    finally:
        core.close()
    assert rc == 0, err.getvalue()
    rows = _rows(out.getvalue())
    assert _check_keys(rows) == {"vision", "vision_cuda_shm",
                                 "vision_concurrent",
                                 "vision_concurrent_best"}
    shm_rows = [r for r in rows if "cuda_shm" in r["metric"]]
    assert [r["metric"] for r in shm_rows] == [
        "resnet50_grpc_cuda_shm_hygienic_b1_conc4",
        "densenet121_grpc_cuda_shm_hygienic_b1_conc4"]
    dispatches = bench_full.bench_vision_cuda_shm.dispatches - dispatches0
    assert dispatches == 2 * (3 * 32 + 16)
    assert reads == dispatches
    assert not core.cuda_shm_status() and not core.system_shm_status()
    mine = ("resnet50_", "densenet121_")
    assert not [h.name for h in csm.allocated_shared_memory_regions()
                if h.name.startswith(mine)]
    # config 2's system region: a key of this run's own, not left on disk
    keys = bench_full._vision_call_system_shm.keys[keys0:]
    assert len(keys) == 1 and all(str(os.getpid()) in k for k in keys)
    assert not [k for k in keys if os.path.exists("/dev/shm" + k)]


def test_fence_and_verify_refuses_wrong_and_replayed_outputs():
    """The window check itself: a sampled slot off its in-band answer, and
    two samples bit-identical (a replayed answer), each fail."""
    out_bytes = 4000
    h = csm.create_shared_memory_region("fence", 3 * out_bytes, device="cpu")
    try:
        rows = np.random.RandomState(0).rand(3, 1, 1000).astype(np.float32)
        for s in range(3):
            csm.set_shared_memory_region(h, [rows[s]], offset=s * out_bytes)
        refs = {s: rows[s] for s in range(3)}
        bench_full._fence_and_verify(csm, h, [1, 1000], out_bytes, 3,
                                     [0, 1, 2], refs)
        with pytest.raises(AssertionError):
            bench_full._fence_and_verify(
                csm, h, [1, 1000], out_bytes, 3, [0, 1, 2],
                {**refs, 1: rows[1] + 0.1})
        csm.set_shared_memory_region(h, [rows[0]], offset=out_bytes)
        with pytest.raises(AssertionError, match="bit-identical"):
            bench_full._fence_and_verify(
                csm, h, [1, 1000], out_bytes, 3, [0, 1, 2],
                {**refs, 1: rows[0]})
    finally:
        csm.destroy_shared_memory_region(h)


class _RecordingBackend:
    """The calls ``_vision_call_system_shm`` makes, recorded; ``infer``
    reads the region back through the key it was registered with."""

    def __init__(self):
        self.registered = {}
        self.seen = []

    def shm_register(self, name, kind, key=None, byte_size=0):
        self.registered[name] = key

    def shm_unregister(self, name, kind):
        del self.registered[name]

    def prepare_shm(self, model, input_refs):
        return input_refs

    def infer(self, prepared):
        (ref,) = prepared.values()
        key = self.registered[ref["shared_memory_region"]]
        with open("/dev/shm" + key, "rb") as f:
            self.seen.append(np.frombuffer(f.read(), np.float32).copy())


def test_system_region_keys_are_unique_to_each_call():
    """Two system-region calls on one model (as two runs on one host
    would make) get keys of their own, with this process's id in them;
    each writes its own images and its cleanup unlinks only its file."""
    imgs = [np.full((1, 4, 4, 3), v, np.float32) for v in (1.0, 2.0)]
    backend = _RecordingBackend()
    cleanups = []
    try:
        calls = []
        for _ in range(2):
            call, cleanup = bench_full._vision_call_system_shm(
                backend, "resnet50", imgs)
            calls.append(call)
            cleanups.append(cleanup)
        keys = list(backend.registered.values())
        assert len(set(keys)) == 2
        assert keys == bench_full._vision_call_system_shm.keys[-2:]
        assert all(k.startswith("/resnet50_in_{}_".format(os.getpid()))
                   for k in keys)
        calls[0](0)
        calls[1](1)
        assert [float(s[0]) for s in backend.seen] == [1.0, 2.0]
        cleanups.pop(0)()
        assert not os.path.exists("/dev/shm" + keys[0])
        assert os.path.exists("/dev/shm" + keys[1])
    finally:
        for cleanup in cleanups:
            cleanup()
    assert not [k for k in keys if os.path.exists("/dev/shm" + k)]


def test_a_config_that_raises_is_reported_and_exits_1():
    """Config 1 against a core without ``simple``: its error goes to
    stderr as ``{"config": 1, "error": ...}``, no row is printed, and
    ``main`` returns 1."""
    core = InferenceServer([])
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench_full.main(["--quick", "--device", "cpu", "--configs",
                                  "1"], core=core)
    finally:
        core.close()
    assert rc == 1
    assert not _rows(out.getvalue())
    (line,) = [json.loads(ln) for ln in err.getvalue().splitlines()
               if ln.startswith('{"config"')]
    assert line["config"] == 1 and "simple" in line["error"]


def test_without_a_card_and_without_device_cpu_it_fails():
    proc = subprocess.run(
        [sys.executable, "-m", "tpuserver_torch.bench_full", "--quick",
         "--configs", "1"],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=REPO)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and not _rows(proc.stdout)


def test_bench_python_driver_prints_one_line():
    """``python -m tpuserver_torch.bench --driver python``: one JSON line,
    the JAX bench's keys and the driver that measured it."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpuserver_torch.bench", "--driver",
         "python"],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (line,) = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "p50_usec", "p50_vs_baseline", "driver"}
    assert line["driver"] == "python"
    assert line["metric"] == "simple_http_sync_conc1_infer_per_sec"
    assert line["value"] > 0 and line["p50_usec"] > 0


def test_a_run_over_the_sockets_imports_nothing_of_the_jax_side():
    """A config-1 run over HTTP loads none of ``jax``, ``tpuserver``,
    ``tritonclient``, the JAX side's ``perfanalyzer`` or the root
    ``bench``/``bench_full`` modules."""
    script = (
        "import contextlib, io, sys\n"
        "from tpuserver_torch import bench_full\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    rc = bench_full.main(['--quick', '--device', 'cpu',\n"
        "                          '--configs', '1'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'tpuserver', 'tritonclient', 'perfanalyzer',\n"
        "              'bench', 'bench_full'))\n"
        "print(rc, bad)\n"
        "sys.exit(1 if rc or bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120, env=_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
