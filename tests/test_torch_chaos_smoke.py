"""The port's chaos soak (``python -m tpuserver_torch.chaos_smoke``), its
in-process modes on the CPU: the default rounds with the overload phase,
``--kill-loop`` and ``--shm`` (host regions) run as processes and exit 0
with their OK lines; a planted violation of each invariant these modes
hold (a token corrupted after a restart, a leaked stream, a stale
``kvexport/*`` region) exits 1 with an ``INVARIANT VIOLATED`` line; the
soak's fault-free reference tokens equal the JAX package's
``LlamaGenerateModel``'s on the same float32 ``tiny`` weights; and a
restart budget set on the port's model trips as the scheduler's own
does.  The router, fleet and stub modes are in
``test_torch_chaos_smoke_fleet.py`` and ``test_torch_chaos_smoke_stubs.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import chaos_cli as run_cli
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from tpuserver.core import InferenceServer as JaxServer
from tpuserver.core import InferRequest as JaxRequest
from tpuserver.models import llama as jl
from tpuserver.models.llama_serving import \
    LlamaGenerateModel as JaxLlamaGenerateModel
from tpuserver_torch import chaos_smoke
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.errors import ServerUnavailable
from tpuserver_torch.models import llama as tl
from tpuserver_torch.scheduler import DecodeScheduler

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("args, ok", [
    (["--rounds", "4"], "\nchaos smoke OK: 4 rounds + overload phase"),
    (["--kill-loop", "--rounds", "2", "--max-seq", "128"],
     "kill-loop chaos smoke OK: 2 loop kills healed"),
    (["--shm", "--rounds", "2"], "shm chaos smoke OK: 2 rounds"),
], ids=["default", "kill-loop", "shm"])
def test_in_process_mode_exits_zero(args, ok):
    rc, out = run_cli(["--device", "cpu"] + args)
    assert rc == 0, out
    assert ok in out
    assert "INVARIANT VIOLATED" not in out
    if args[0] == "--rounds":
        # every fault of the cycle ran, and the shed was typed
        for fault in ("scheduler.step:raise", "scheduler.fetch:raise",
                      "scheduler.admit:raise", "scheduler.step:sleep"):
            assert "fault={}".format(fault) in out
        assert "overload phase: shed typed 429" in out


def test_pool_is_not_ported_and_exits_2():
    rc, out = run_cli(["--pool", "--cycles", "1"], timeout=60)
    assert rc == 2
    assert "tools/chaos_smoke.py --pool" in out


def _corrupt_after_restart(monkeypatch):
    """The first re-admission after a loop restart negates the lm_head:
    every token decoded after the restart diverges."""
    reset = DecodeScheduler._reset_for_readmission
    done = []

    def corrupting(self, stream):
        reset(self, stream)
        if not done:
            done.append(True)
            self._params["lm_head"].neg_()

    monkeypatch.setattr(DecodeScheduler, "_reset_for_readmission",
                        corrupting)


def _leak_a_stream(monkeypatch):
    """The first completed stream stays in the live registry."""
    deliver = DecodeScheduler._deliver
    done = []

    def leaking(self, stream, event, epoch):
        deliver(self, stream, event, epoch)
        if event[0] == "done" and not done:
            done.append(True)
            with self._cond:
                self._streams.add(stream)

    monkeypatch.setattr(DecodeScheduler, "_deliver", leaking)


def _keep_kv_exports(monkeypatch):
    """A KV export is never released (``kvexport/*`` goes stale)."""
    monkeypatch.setattr(InferenceServer, "drop_kv_region",
                        lambda self, generation_id: None)


@pytest.mark.parametrize("plant, args, expect", [
    (_corrupt_after_restart, ["--kill-loop", "--rounds", "1"],
     "tokens corrupted"),
    (_leak_a_stream, ["--kill-loop", "--rounds", "1"], "leaked streams"),
    (_keep_kv_exports, ["--shm", "--rounds", "1"],
     "cuda_shm_status inconsistent"),
], ids=["token-after-restart", "leaked-stream", "stale-kvexport"])
def test_planted_violation_exits_one(plant, args, expect, monkeypatch,
                                     capsys):
    plant(monkeypatch)
    rc = chaos_smoke.main(["--device", "cpu"] + args)
    err = capsys.readouterr().err
    assert rc == 1, err
    assert "INVARIANT VIOLATED: " in err and expect in err, err
    assert "chaos smoke FAILED" in err


@pytest.fixture(scope="module")
def weights():
    """JAX's float32 ``tiny`` config at vocab 512, and its
    ``llama.init_params(PRNGKey(0))`` bridged to the port."""
    cfg = dataclasses.replace(jl.tiny(vocab=512), dtype=jnp.float32)
    return cfg, tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), cfg)), "cpu")


def _jax_tokens(cfg, prompts, budget):
    # the JAX model draws init_params(PRNGKey(0)) itself
    model = JaxLlamaGenerateModel(cfg=cfg, max_seq=chaos_smoke.MAX_SEQ,
                                  max_slots=2)
    core = JaxServer([model])
    try:
        out = []
        for prompt in prompts:
            req = JaxRequest("llama_generate", inputs={
                "PROMPT_IDS": np.asarray(prompt, np.int32),
                "MAX_TOKENS": np.array([budget], np.int32)})
            out.append([int(arr[0]) for resp in core.infer_stream(req)
                        for spec, arr, _ in resp.outputs
                        if spec["name"] == "TOKEN"])
        return out
    finally:
        core.close()


def test_reference_tokens_equal_jax(weights, capsys):
    """The default soak on the bridged weights: its printed fault-free
    reference is JAX's greedy tokens for the same prompts, and the
    shared-prefix prompt of the router and fleet modes agrees too."""
    cfg, tparams = weights
    jax_ref = _jax_tokens(cfg, chaos_smoke.PROMPTS
                          + [chaos_smoke.SHARED_PROMPT], 6)
    assert chaos_smoke.main(["--device", "cpu", "--rounds", "1"],
                            params=tparams) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("reference tokens captured: "))
    printed = line[len("reference tokens captured: "):].split(";")[0]
    assert printed == str(jax_ref[:4])
    serving = chaos_smoke.Serving("tiny", "float32", "cpu", tparams)
    core = InferenceServer([serving.model(2, 5)])
    try:
        assert chaos_smoke.generate(core, chaos_smoke.SHARED_PROMPT, 6) == \
            jax_ref[4]
    finally:
        core.close()


@pytest.mark.parametrize("via", ["model", "scheduler"])
def test_restart_budget_on_the_model_trips_as_on_the_scheduler(
        weights, via):
    """``LlamaGenerateModel(max_restarts=2, restart_backoff_s=0.01)``
    passes its budget to the scheduler it builds: a loop that dies on
    every step trips after two restarts with the scheduler's 503, as a
    ``DecodeScheduler`` built with the same keywords does."""
    _, tparams = weights
    serving = chaos_smoke.Serving("tiny", "float32", "cpu", tparams)
    model = serving.model(2, 2)
    if via == "scheduler":
        sched = DecodeScheduler(model._fns, tparams, 2, chaos_smoke.MAX_SEQ,
                                max_restarts=2, restart_backoff_s=0.01)
        model._scheduler = sched
    core = InferenceServer([model])
    try:
        sched = model._ensure_scheduler()
        assert (sched._max_restarts, sched._restart_backoff_s) == (2, 0.01)

        def dead_step(*args):
            raise RuntimeError("injected device fault")

        sched._fns = dict(sched._fns, step=dead_step)
        with pytest.raises(ServerUnavailable,
                           match="restart budget exhausted") as info:
            chaos_smoke.generate(core, chaos_smoke.PROMPTS[0], 6)
        assert info.value.code == 503
        assert sched.stats()["restarts"] == 2 and sched.stats()["tripped"]
    finally:
        core.close()
