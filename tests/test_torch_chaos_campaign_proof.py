"""The port's ``python -m tpuserver_torch.chaos_campaign --proof``
beside the JAX package's ``tools/chaos_campaign.py --proof``:

- ``--proof``, ``--workers`` and ``--concurrency`` parse as the JAX
  tool's do, defaults included;
- one small proof (one cycle composing ``prefill_sigkill`` and
  ``stream_sever``, two ``perf_analyzer`` workers of four streams each,
  through the active ``router_cli`` process of a supervised stub fleet)
  exits 0 and writes a row with the JAX tool's keys (read from the
  literal its ``run_proof`` writes), an error budget of 0, 8 streams
  and the fault kinds asked for."""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from tpuserver_torch import chaos_campaign

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
JAX_CAMPAIGN = os.path.join(REPO, "tools", "chaos_campaign.py")

pytestmark = pytest.mark.torch_port

FAULTS = ("prefill_sigkill", "stream_sever")


def _jax_parser():
    spec = importlib.util.spec_from_file_location(
        "jax_chaos_campaign_for_proof", JAX_CAMPAIGN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


def _action(parser, flag):
    return next(a for a in parser._actions if flag in a.option_strings)


def _jax_row_keys():
    """The keys of the row literal JAX's ``run_proof`` writes."""
    with open(JAX_CAMPAIGN) as fh:
        tree = ast.parse(fh.read())
    run_proof = next(node for node in tree.body
                     if isinstance(node, ast.FunctionDef)
                     and node.name == "run_proof")
    for node in ast.walk(run_proof):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "row"
                and isinstance(node.value, ast.Dict)):
            return {key.value for key in node.value.keys}
    raise AssertionError("no row literal in JAX's run_proof")


@pytest.mark.parametrize("flag", ["--proof", "--workers", "--concurrency"])
def test_proof_flags_match_the_jax_tool(flag):
    port = _action(chaos_campaign.build_parser(), flag)
    jax = _action(_jax_parser(), flag)
    for attr in ("dest", "default", "type", "metavar", "nargs"):
        assert getattr(port, attr) == getattr(jax, attr), attr
    args = chaos_campaign.build_parser().parse_args([])
    assert (args.proof, args.workers, args.concurrency) == (None, 2, 32)


def test_small_proof_writes_the_jax_row(tmp_path):
    row_path = tmp_path / "proof_row.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src", "python"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "tpuserver_torch.chaos_campaign",
         "--proof", str(row_path), "--seed", "0", "--cycles", "1",
         "--faults", ",".join(FAULTS), "--workers", "2",
         "--concurrency", "4"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=240)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    assert "INVARIANT VIOLATED" not in proc.stderr
    row = json.loads(row_path.read_text())
    assert set(row) == _jax_row_keys()
    assert row["config"] == "chaos_campaign_proof"
    assert row["error_budget"] == 0
    assert row["streams"] == 8 and row["workers"] == 2
    assert row["fault_kinds"] == list(FAULTS)
    assert row["cycles"] == 1 and row["seed"] == 0
    assert row["unit"] == "tokens/sec" and row["value"] > 0
    assert row["ttft_p50_ms"] <= row["ttft_p99_ms"]
    # the perf run's temporary rows are gone
    assert not os.path.exists(str(row_path) + ".perf.tmp")
