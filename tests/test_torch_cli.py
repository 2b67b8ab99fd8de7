"""The port's CLI (``python -m tpu_paxos_torch``) against the JAX CLI,
the port's import boundary (no ``jax``, no ``tpu_paxos``), and the
committed JAX goldens that ``chip_smoke.py`` holds the card run to."""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from tpu_paxos_torch import __main__ as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")
DEBUG_ARGS = ["4", "4", "10", "--seed=0", "--net-drop-rate=500",
              "--net-dup-rate=1000", "--net-max-delay=2"]


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    return env


def _python(*args, timeout=240):
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=timeout,
    )


def _goldens():
    with open(GOLDENS) as f:
        return json.load(f)


def test_cli_stdout_is_byte_identical_to_the_jax_cli():
    jax_run = _python("-m", "tpu_paxos", *DEBUG_ARGS, "--backend", "cpu")
    port_run = _python("-m", "tpu_paxos_torch", *DEBUG_ARGS, "--device", "cpu")
    assert jax_run.returncode == 0, jax_run.stderr
    assert port_run.returncode == 0, port_run.stderr
    assert port_run.stdout == jax_run.stdout
    assert "ALL INVARIANTS GREEN" in port_run.stdout.splitlines()[-1]
    # the decision log (all but the verdict line) is the committed golden
    log = "".join(port_run.stdout.splitlines(keepends=True)[:-1])
    gold = _goldens()["cli_4_4_10"]
    assert hashlib.sha256(log.encode()).hexdigest() == gold["decision_log_sha256"]


def test_cli_json_summary_equals_the_jax_cli(capsys):
    """A crash loses the crashed proposer's queued value, so both CLIs
    must report the same failed verdict and exit 1."""
    from tpu_paxos import __main__ as jcli

    argv = ["3", "2", "6", "--seed=4", "--net-drop-rate=900",
            "--crash-rate=20000", "--net-max-delay=1", "--json"]
    assert jcli.main(argv) == tcli.main(argv + ["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]
    summary = json.loads(out.splitlines()[-1])
    assert (summary["ok"], summary["crashed"], summary["done"]) == (False, 1, True)


@pytest.mark.parametrize("argv,what", [
    (["4", "4", "10", "--engine=fast"], "--engine=fast"),
    (["4", "4", "10", "--engine=member"], "--engine=member"),
    (["4", "4", "10", "--mesh", "2"], "--mesh"),
    (["repro", "artifact.json"], "'repro'"),
])
def test_unported_cli_surfaces_exit_2(argv, what, capsys):
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    assert f"{what} is not ported yet" in capsys.readouterr().err


_BLOCKED_IMPORT_PROBE = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_paxos"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import tpu_paxos_torch
mods = [m.name for m in pkgutil.walk_packages(tpu_paxos_torch.__path__, "tpu_paxos_torch.")]
for m in mods:
    importlib.import_module(m)
from tpu_paxos_torch import config
from tpu_paxos_torch.core import sim
res = sim.run(config.SimConfig(n_nodes=3, n_instances=16, proposers=(0, 1)), device="cpu")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_paxos"))
print(len(mods), bool(res.done), loaded)
"""


def test_port_imports_and_runs_with_jax_and_tpu_paxos_blocked():
    proc = _python("-c", _BLOCKED_IMPORT_PROBE, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_mods, done, loaded = proc.stdout.split(maxsplit=2)
    assert int(n_mods) >= 20  # every module of the package was imported
    assert done == "True"
    assert loaded.strip() == "[]"


def _golden_script():
    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_committed_goldens_recompute_from_jax():
    """The full-size golden (2**23 instances) recomputed from the JAX
    package equals the committed file, byte for byte."""
    script = _golden_script()
    text = json.dumps(script.compute(), indent=1, sort_keys=True) + "\n"
    with open(GOLDENS) as f:
        assert f.read() == text
