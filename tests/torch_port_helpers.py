"""What the port's fleet-tier tests share (``test_torch_fleet.py`` and
``test_torch_disagg.py``): the float32 ``tiny`` config of both packages,
the JAX weights bridged to the port, one torch thread per test process,
a deadline poll and an SSE reader; and a hold on a scheduler's decode
loop for the tests that drop a stream (``test_torch_grpc.py``,
``test_torch_perfanalyzer_sockets.py``); and the chaos soak's CLI as a
process (``test_torch_chaos_smoke*.py``).  A test module imports the
fixtures by name, so pytest finds them there."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserver.models import llama as jl
from tpuserver_torch.models import llama as tl

VOCAB = 512
WAIT_S = 60.0
SRC_PY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src", "python")


def tiny_cfgs():
    """(JAX config, port config): ``tiny`` at float32."""
    return (dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=jnp.float32),
            dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per process: tiny steps stay short when
    several test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tparams():
    """The port's weights, bridged from ``llama.init_params(PRNGKey(0))``."""
    return tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), tiny_cfgs()[0])),
        "cpu")


def wait_for(predicate, what, timeout=WAIT_S):
    """Poll ``predicate`` until it holds; fail after ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError("timed out after {} s waiting for {}".format(
        timeout, what))


def sse_events(resp):
    """Each ``data:`` event of a ``generate_stream`` response as (the seq
    of its ``id:`` line, or None without one, the event), up to and
    including the ``final`` one."""
    seq = None
    for raw in resp:
        line = raw.strip()
        if line.startswith(b"id: "):
            seq = int(line.rsplit(b"/", 1)[1])
        elif line.startswith(b"data: "):
            event = json.loads(line[len(b"data: "):])
            yield seq, event
            if event.get("final"):
                return
            seq = None


class StepHold:
    """Holds a scheduler's decode loop inside its ``at``-th step call
    from now until ``first()`` is true (``timed_out`` if it never is),
    then slows every later step call, up to ``PACE_S`` each, until
    ``then()`` is true.  A dropped stream's consumer notices the drop
    only when its next token arrives, so the loop must go on stepping,
    slowly enough that the generation is still live (and its KV exported
    when it is reaped) when its consumer goes, however loaded the
    machine."""

    PACE_S = 0.5

    def __init__(self, model, at, first, then):
        fns = model._ensure_scheduler()._fns
        self._step = fns["step"]
        self._calls = 0
        self._at = at
        self._first = first
        self._then = then
        self.timed_out = False
        fns["step"] = self._held  # the loop looks it up per call

    def _wait(self, cond, limit):
        deadline = time.monotonic() + limit
        while not cond():
            if time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def _held(self, *args):
        self._calls += 1
        if self._calls == self._at:
            self.timed_out = not self._wait(self._first, WAIT_S)
        elif self._calls > self._at and self._then is not None:
            if self._wait(self._then, self.PACE_S):
                self._then = None
        return self._step(*args)


def parked_since(model, gen_id, hits0):
    """True once generation ``gen_id`` parked (its consumer gone): it is
    in the replay buffer, or a resume took it from there already."""
    sched = model._scheduler
    with sched._cond:
        return gen_id in sched._replay or sched._replay_hits > hits0


def chaos_cli(args, timeout=240):
    """``python -m tpuserver_torch.chaos_smoke`` as a process (the chaos
    soak's tests): ``(exit code, output)``."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpuserver_torch.chaos_smoke"] + list(args),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=SRC_PY, OMP_NUM_THREADS="1"))
    return proc.returncode, proc.stdout.decode(errors="replace")
