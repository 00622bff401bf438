"""What the port's fleet-tier tests share (``test_torch_fleet.py`` and
``test_torch_disagg.py``): the float32 ``tiny`` config of both packages,
the JAX weights bridged to the port, one torch thread per test process,
a deadline poll and an SSE reader.  A test module imports the fixtures
by name, so pytest finds them there."""

import dataclasses
import json
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
