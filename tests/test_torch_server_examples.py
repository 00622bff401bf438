"""The port's server-side demos beside the JAX package's, as processes on
the CPU: ``simple_http_router_torch.py`` against ``simple_http_router.py``
and ``simple_fleet_torch.py`` against ``simple_fleet.py``.

Each port demo exits 0 and prints ``PASS:``; its lines equal the JAX
demo's line by line once URLs, pids, tokens and counts are masked (the
replicas' own startup and shutdown lines, which each package words its
own way, are left out).  Every process a port demo starts, the demo
itself and its replicas, runs under a ``sitecustomize`` that records any
import of ``jax`` or ``tpuserver``: none may happen."""

import os
import re
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "src", "python", "examples")
SRC = os.path.join(REPO, "src", "python")
# the replicas' own lines (inherited stdout), by package
REPLICA_LINES = {"jax": re.compile(r"^replica\["),
                 "port": re.compile(r"^(serving |stopped$)")}

# records, in the file $IMPORT_GUARD_LOG, every process it starts in and
# every import of a forbidden top-level package
GUARD = '''
import os
import sys

_LOG = os.environ["IMPORT_GUARD_LOG"]
_FORBIDDEN = ("jax", "jaxlib", "tpuserver")


def _note(line):
    with open(_LOG, "a") as fh:
        fh.write(line + "\\n")


class _Guard:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _FORBIDDEN:
            _note("IMPORT {} {}".format(os.getpid(), name))
        return None


sys.meta_path.insert(0, _Guard())
_note("START {} {}".format(os.getpid(), " ".join(sys.argv)))
'''


def _mask(text):
    text = re.sub(r"127\.0\.0\.1:\d+", "HOST:PORT", text)
    text = re.sub(r"\[[\d, ]*\]", "[LIST]", text)
    return re.sub(r"\d+", "N", text)


def _lines(out, side):
    return [_mask(ln) for ln in out.splitlines()
            if ln and not REPLICA_LINES[side].match(ln)]


def _run(script, argv, tmp_path, guard=False):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    log = tmp_path / "imports.log"
    if guard:
        guard_dir = tmp_path / "guard"
        guard_dir.mkdir()
        (guard_dir / "sitecustomize.py").write_text(GUARD)
        env["PYTHONPATH"] = os.pathsep.join([str(guard_dir), SRC])
        env["IMPORT_GUARD_LOG"] = str(log)
    # the demos' replicas inherit stdout: a file, since a pipe stays open
    # while any of them lives
    out_path = tmp_path / (script + ".out")
    with open(out_path, "w") as out:
        proc = subprocess.run(
            [sys.executable, os.path.join(EXAMPLES, script)] + argv,
            stdout=out, stderr=subprocess.PIPE, text=True, timeout=300,
            env=env)
    out = out_path.read_text()
    assert proc.returncode == 0, out + proc.stderr
    return out, (log.read_text().splitlines() if guard else None)


def _guarded(records, processes):
    """The guard's records: at least ``processes`` processes started, and
    no forbidden import in any."""
    starts = [r for r in records if r.startswith("START ")]
    assert len(starts) >= processes, records
    assert [r for r in records if r.startswith("IMPORT ")] == []


@pytest.mark.parametrize("port_script,jax_script,processes", [
    ("simple_http_router_torch.py", "simple_http_router.py", 1),
    ("simple_fleet_torch.py", "simple_fleet.py", 4),
], ids=["router", "fleet"])
def test_demo_passes_and_matches_jax(port_script, jax_script, processes,
                                     tmp_path):
    """The fleet demo's processes: the demo, two replicas and the
    SIGKILLed one's respawn."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port_out, records = _run(port_script, ["--device", "cpu"],
                             tmp_path / "port", guard=True)
    jax_out, _ = _run(jax_script, [], tmp_path / "jax")
    assert "PASS:" in port_out
    assert _lines(port_out, "port") == _lines(jax_out, "jax")
    _guarded(records, processes)


def test_router_demo_hands_off_token_identically(tmp_path):
    """The severed stream's tokens through the router equal the
    fault-free reference, with at least one handoff recorded."""
    out, _ = _run("simple_http_router_torch.py", ["--device", "cpu", "-t",
                                                  "12"], tmp_path)
    lines = dict(ln.split(": ", 1) for ln in out.splitlines()
                 if ln.startswith(("reference tokens", "tokens through")))
    reference = lines["reference tokens"]
    assert lines["tokens through the kill"] == reference
    assert len(reference.strip("[]").split(",")) == 12
    handoffs = re.search(r"handoffs=(\d+)", out)
    assert handoffs and int(handoffs.group(1)) >= 1


def test_fleet_demo_respawns_the_killed_replica(tmp_path):
    """The SIGKILLed replica comes back under a new pid; every request of
    the three rounds succeeds."""
    out, _ = _run("simple_fleet_torch.py", ["--device", "cpu", "-n", "4"],
                  tmp_path)
    killed = re.search(r"SIGKILL replica (\S+) \(pid (\d+)\)", out).group(2)
    assert re.search(r"healed: restarts=[1-9]\d* up=2", out)
    for label in ("healthy fleet", "one replica dead", "healed fleet"):
        assert "{}: 4/4 requests ok".format(label) in out
    pids = re.findall(r"pid=(\d+)", out)
    assert killed in pids and "FAIL" not in out
