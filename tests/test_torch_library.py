"""The port's library surface against the JAX package's, on the CPU, with
exact equality (all state is integer): the vid codec, ``InternTable`` and
``decode_host`` (``core/values.py``), ``ballot.node_of``,
``apply.frontier``/``frontiers``, ``SimResult.rounds_to_chosen`` and
``value_status``, ``--trace-dir`` (``utils/log.profile_trace``), the C++
parity harness (``harness/reference_runner.py``), the five examples
(``tpu_paxos_torch/examples``), the wall-paced member replay diff
(``scripts/torch_replay_diff_member.py``) and the strict-mode smoke
(``scripts/torch_check_smoke.py``)."""

import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_paxos import config as jcfg
from tpu_paxos.core import apply as japply
from tpu_paxos.core import ballot as jbal
from tpu_paxos.core import sim as jsim
from tpu_paxos.core import values as jval
from tpu_paxos.harness import reference_runner as jref
from tpu_paxos.harness import validate as jvalidate
from tpu_paxos_torch import __main__ as tcli
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch.core import apply as tapply
from tpu_paxos_torch.core import ballot as tbal
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.core import values as tval
from tpu_paxos_torch.examples import TWINS
from tpu_paxos_torch.harness import reference_runner as tref
from tpu_paxos_torch.harness import validate as tvalidate
from tpu_paxos_torch.utils import log as tlog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRASH_ARGS = ["3", "2", "6", "--seed=4", "--net-drop-rate=900", "--crash-rate=20000",
              "--net-max-delay=1", "--json"]
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _goldens():
    with open(os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")) as f:
        return json.load(f)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vids(seed: int, n: int = 4096, stride: int = 1 << 10, n_inst: int = 1 << 12) -> np.ndarray:
    """Seeded int32 vids: real, NONE, no-op and boundary values mixed."""
    r = np.random.default_rng(seed)
    real = r.integers(0, 64 * stride, n)
    noop = -2 - r.integers(0, 8 * n_inst, n)
    pick = r.integers(0, 3, n)
    v = np.where(pick == 0, real, np.where(pick == 1, noop, -1))
    edges = [-1, -2, -3, 0, 1, stride - 1, stride, -2 - n_inst, -1 - n_inst, INT32_MAX,
             INT32_MIN, INT32_MIN + 1]
    return np.concatenate([v, edges]).astype(np.int32)


def _same(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    got = t.numpy()
    assert got.dtype == j.dtype and got.shape == j.shape
    np.testing.assert_array_equal(got, j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vid_codec_equals_jax(seed):
    stride, n_inst = 1 << 10, 1 << 12
    v = _vids(seed, stride=stride, n_inst=n_inst)
    tv = torch.from_numpy(v)
    r = np.random.default_rng(seed + 100)
    prop = r.integers(0, 7, v.size).astype(np.int32)
    seq = r.integers(0, stride, v.size).astype(np.int32)
    inst = r.integers(0, n_inst, v.size).astype(np.int32)
    _same(tval.real_vid(torch.from_numpy(prop), torch.from_numpy(seq), stride),
          jval.real_vid(prop, seq, stride))
    _same(tval.real_vid(3, 5, stride), jval.real_vid(3, 5, stride))
    _same(tval.real_proposer_of(tv, stride), jval.real_proposer_of(v, stride))
    _same(tval.real_seq_of(tv, stride), jval.real_seq_of(v, stride))
    _same(tval.is_noop(tv), jval.is_noop(v))
    _same(tval.is_none(tv), jval.is_none(v))
    for t, j in zip(tval.noop_decode(tv, n_inst), jval.noop_decode(v, n_inst)):
        _same(t, j)
    _same(tval.noop_vid(torch.from_numpy(inst), torch.from_numpy(prop), n_inst),
          jval.noop_vid(inst, prop, n_inst))
    for x in v[v != -1][:512].tolist() + [-2, 0]:
        assert tval.decode_host(x, stride, n_inst) == jval.decode_host(x, stride, n_inst)


def _raised(fn):
    try:
        fn()
    except (KeyError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


def test_intern_table_and_host_decode_errors_equal_jax():
    jt, tt = jval.InternTable(), tval.InternTable()
    payloads = ["a", b"a", "m+1=127.0.0.1:8000", b"\x00\xff", "", "a", "z" * 300]
    assert [tt.intern(p) for p in payloads] == [jt.intern(p) for p in payloads] == [
        0, 0, 1, 2, 3, 0, 4]
    assert len(tt) == len(jt) == 5
    for vid in range(5):
        assert tt.payload(vid) == jt.payload(vid)
    for bad in (5, -1, -2, 1 << 20):
        assert _raised(lambda: tt.payload(bad)) == _raised(lambda: jt.payload(bad)) is not None
    got = _raised(lambda: tval.decode_host(-1, 10, 80))
    assert got == _raised(lambda: jval.decode_host(-1, 10, 80)) == ("ValueError",
                                                                      "NONE has no decoding")


@pytest.mark.parametrize("seed", [0, 1])
def test_node_of_and_frontiers_equal_jax(seed):
    r = np.random.default_rng(seed)
    b = np.concatenate([r.integers(0, INT32_MAX, 2048), [-1, 0, 65535, 65536, INT32_MAX,
                                                          INT32_MIN]]).astype(np.int32)
    _same(tbal.node_of(torch.from_numpy(b)), jbal.node_of(b))
    _same(tbal.node_of(7 << 16 | 3), jbal.node_of(7 << 16 | 3))
    for i, a in ((64, 5), (1, 3), (1000, 1)):
        learned = np.where(r.random((i, a)) < 0.9, r.integers(-5, 100, (i, a)), -1)
        learned[: i // 2] = np.where(learned[: i // 2] == -1, 7, learned[: i // 2])
        learned = learned.astype(np.int32)
        _same(tapply.frontiers(torch.from_numpy(learned)), japply.frontiers(learned))
        for col in range(a):
            _same(tapply.frontier(torch.from_numpy(learned[:, col])),
                  japply.frontier(learned[:, col]))
    full = np.zeros((16, 2), np.int32)
    _same(tapply.frontiers(torch.from_numpy(full)), japply.frontiers(full))
    _same(tapply.frontiers(torch.full((16, 2), -1, dtype=torch.int32)),
          japply.frontiers(np.full((16, 2), -1, np.int32)))


#: the configs ``rounds_to_chosen``/``value_status`` are held on: the CLI's
#: debug line (JAX's side: ``goldens.json``'s ``library.cli_4_4_10``) and a
#: crash run that loses a value (JAX live)
STATUS_CASES = {
    "cli_4_4_10": ((4, 4, 10), dict(seed=0, faults=dict(drop_rate=500, dup_rate=1000,
                                                        max_delay=2))),
    "crash_3_2_6": ((3, 2, 6), dict(seed=4, faults=dict(drop_rate=900, crash_rate=20000,
                                                        max_delay=1))),
}
#: vids asked beside the workload's: NONE, two no-ops and one never proposed
EXTRA_VIDS = [-1, -2, -7, 10_000]


def _status_run(cfgm, sim, ref, case, **kw):
    (srv, clt, ids), c = STATUS_CASES[case]
    workload, gates, _ = ref.equivalent_workload(srv, clt, ids)
    cfg = cfgm.SimConfig(n_nodes=srv, n_instances=clt * ids * 2, proposers=tuple(range(srv)),
                         seed=c["seed"], faults=cfgm.FaultConfig(**c["faults"]))
    return sim.run(cfg, workload, gates, **kw)


def _status(res) -> dict:
    """``rounds_to_chosen`` (length, sum, max, sha256) and ``value_status``
    of every workload vid and :data:`EXTRA_VIDS`, as the golden holds them."""
    vids = sorted(int(v) for v in np.asarray(res.expected_vids)) + EXTRA_VIDS
    return json.loads(json.dumps({
        "rounds_to_chosen": tsim.rounds_to_chosen_digest(res.rounds_to_chosen),
        "value_status": [[v, res.value_status(v)] for v in vids]}))


@pytest.fixture(scope="module")
def status_runs():
    """One run per package and config (the debug line's JAX run is its
    committed golden), shared by the status tests."""
    gold = _goldens()["library"]["cli_4_4_10"]
    return {"cli_4_4_10": (gold, _status_run(tcfg, tsim, tref, "cli_4_4_10", device="cpu")),
            "crash_3_2_6": (_status_run(jcfg, jsim, jref, "crash_3_2_6"),
                            _status_run(tcfg, tsim, tref, "crash_3_2_6", device="cpu"))}


@pytest.mark.parametrize("case", sorted(STATUS_CASES))
def test_rounds_to_chosen_equals_jax(status_runs, case):
    j, t = status_runs[case]
    got = t.rounds_to_chosen
    if isinstance(j, dict):
        assert _status(t)["rounds_to_chosen"] == j["rounds_to_chosen"]
        return
    want = np.asarray(j.rounds_to_chosen)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(STATUS_CASES))
def test_value_status_equals_jax(status_runs, case):
    j, t = status_runs[case]
    got = _status(t)["value_status"]
    if isinstance(j, dict):
        assert got == j["value_status"]
    else:
        assert [t.value_status(v) for v, _ in got] == [j.value_status(v) for v, _ in got]
    statuses = [s["status"] for _, s in got]
    assert "applied" in statuses and statuses[-len(EXTRA_VIDS):] == ["pending"] * 4
    if case == "crash_3_2_6":
        # the crash loses a queued value: it never becomes chosen
        assert statuses[: -len(EXTRA_VIDS)].count("pending") >= 1


def test_cli_trace_dir_prints_the_jax_stdout(tmp_path, capsys):
    """``--trace-dir`` writes a parseable Chrome trace and leaves stdout
    the JAX CLI's, byte for byte (the crash line of
    tests/test_torch_cli.py: a failed verdict, exit 1)."""
    out = tmp_path / "trace"
    want = _goldens()["tests"]["cli"]["crash"]
    assert tcli.main(CRASH_ARGS + ["--device", "cpu", "--trace-dir", str(out)]) == want["rc"]
    assert capsys.readouterr().out == want["stdout"]
    with open(out / tlog.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # on the CPU there is no kernel event, and none is required
    assert tlog.trace_kernel_counts(str(out / tlog.TRACE_FILE)) == {}


def test_profile_trace_is_a_no_op_without_a_directory(tmp_path):
    with tlog.profile_trace("", "cpu"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0 and not os.listdir(tmp_path)


@pytest.mark.parametrize("kw", [{}, dict(srvcnt=5, cltcnt=2, idcnt=6, seed=3, drop_rate=0,
                                         max_delay=20, log_level=0),
                                dict(propose_interval=7, prepare_retry_count=1,
                                     accept_retry_count=9, dup_rate=0, min_delay=5)])
def test_reference_args_equal_jax(kw):
    assert tref.reference_args(**kw) == jref.reference_args(**kw)
    fast = {k: v for k, v in kw.items() if k != "seed"}
    assert tref.fast_reference_args(seed=kw.get("seed", 0), **fast) == \
        jref.fast_reference_args(seed=kw.get("seed", 0), **fast)
    assert tref.fast_reference_args() == jref.fast_reference_args()


def _line(server: int, entries, count=None) -> str:
    """A server's final committed dump in the reference grammar (ref
    multi/paxos.cpp:18-22, printed at :1694-1703)."""
    body = ", ".join(entries)
    n = len(entries) if count is None else count
    return (f"[2026-01-01 00:00:00.000]\t[DEBUG]\t[srv-{server}-paxos:{9000 + server}]\t"
            f"[paxos.cpp:1703]\t[Dump]\tfinal committed values: {body} ({n} in total)")


def _entries(ids, noop_at=(3,)):
    out = []
    for k, v in enumerate(ids):
        if k in noop_at:
            out.append(f"<{65536 + k}>({k % 4}:{100 + k})-")
        out.append(f"<{65537 + k}>({k % 4}:{v})+{v}")
    return out


CLEAN = list(range(40))
#: the synthetic dumps: (servers' id sequences, the count one of them claims, rc, all done)
DUMPS = {
    "clean": ([CLEAN] * 4, None, 0, True),
    "count_mismatch": ([CLEAN] * 4, 99, 0, True),
    "agreement": ([CLEAN, CLEAN, CLEAN[:10] + CLEAN[11:20] + [10] + CLEAN[20:], CLEAN], None,
                  0, True),
    "exactly_once": ([CLEAN[:39] + [5]] * 4, None, 0, True),
    "in_order": ([[0, 2, 1] + CLEAN[3:]] * 4, None, 0, True),
    "missing_server": ([CLEAN] * 3, None, 0, True),
    "rc": ([CLEAN] * 4, None, 134, False),
}


def _dump(name):
    seqs, count, rc, done = DUMPS[name]
    lines = ["[2026-01-01 00:00:00.000]\t[INFO]\t[main]\t[main.cpp:1]\t[main]\tstarting"]
    lines += [_line(s, _entries(ids), count if s == 1 else None) for s, ids in enumerate(seqs)]
    if done:
        lines.append("All done")
    return "\n".join(lines) + "\n", rc


def _outcome(ref, validate, text, rc):
    """(parsed logs as dicts or the parse error, the invariant verdict)."""
    try:
        logs = ref.parse_committed_logs(text)
    except ValueError as e:
        return ("ValueError", str(e)), None
    parsed = {s: [dataclasses.asdict(e) for e in es] for s, es in logs.items()}
    run = ref.ReferenceRun(returncode=rc, all_done="All done" in text, logs=logs, raw_log=text)
    try:
        ref.check_reference_invariants(run, 4, 4, 10)
    except validate.InvariantViolation as e:
        return parsed, (type(e).__name__, str(e))
    return parsed, "ok"


@pytest.mark.parametrize("name", sorted(DUMPS))
def test_parsed_dumps_and_invariants_equal_jax(name):
    text, rc = _dump(name)
    got = _outcome(tref, tvalidate, text, rc)
    assert got == _outcome(jref, jvalidate, text, rc)
    verdict = got[1]
    if name == "clean":
        assert verdict == "ok" and len(got[0][0]) == 41 and got[0][0][3]["noop"]
    elif name == "count_mismatch":
        assert got == (("ValueError", "server 1: parsed 41 entries, dump claims 99"), None)
    else:
        assert verdict[0] == "InvariantViolation"


def test_equivalent_sim_equals_jax():
    """``run_equivalent_sim(4, 4, 10)`` at seeds 0-2: rounds, ``done`` and
    every SimResult array equal JAX's (``goldens.json``'s
    ``library.equivalent_sim``), and the reference's checker holds."""
    gold = _goldens()["library"]["equivalent_sim"]
    for seed in gold["seeds"]:
        res, in_order = tref.run_equivalent_sim(*gold["args"], seed=seed, device="cpu")
        want = gold["runs"][str(seed)]
        assert (res.rounds, res.done) == (want["rounds"], want["done"])
        for f, sha in sorted(want["arrays"].items()):
            a = np.ascontiguousarray(np.asarray(getattr(res, f)), dtype="<i4")
            assert hashlib.sha256(a.tobytes()).hexdigest() == sha, (seed, f)
        seqs = tvalidate.check_all(res.learned, res.expected_vids)
        tvalidate.check_in_order_clients(seqs[0], in_order)


def test_build_reference_names_the_missing_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(tref, "REFERENCE_DIR", str(tmp_path / "multi"))
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "multi")):
        tref.build_reference(str(tmp_path / "build"))
    assert not (tmp_path / "build").exists()


@pytest.fixture(scope="module")
def reference_run():
    """The fast-config reference run from the sources JAX's parity tests
    use, where they and g++ are: exactly the condition under which
    tests/test_parity.py runs."""
    if not (os.path.isdir(jref.REFERENCE_DIR) and shutil.which("g++")):
        pytest.skip("reference sources or g++ unavailable")
    own, tref.REFERENCE_DIR = tref.REFERENCE_DIR, jref.REFERENCE_DIR
    try:
        yield tref.run_reference(tref.fast_reference_args(seed=0), timeout=300)
    finally:
        tref.REFERENCE_DIR = own


def test_reference_builds_runs_and_passes_the_checker(reference_run):
    assert reference_run.returncode == 0 and reference_run.all_done
    assert set(reference_run.logs) == {0, 1, 2, 3}
    tref.check_reference_invariants(reference_run, srvcnt=4, cltcnt=4, idcnt=10)


def test_check_parity_on_the_port(reference_run):
    out = tref.check_parity(device="cpu")
    assert out["parity"] and out["tpu_paxos_torch"]["executed"] == 40
    assert out["reference"]["executed"] == 40


_BLOCK = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_paxos"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.argv = [sys.argv[1], "--device", "cpu"]
runpy.run_module(sys.argv[0], run_name="__main__")
"""

#: the JAX examples tests/test_examples.py runs in the slow tier
_SLOW_EXAMPLES = ("faulty_run", "sharded_and_checkpoint", "crash_rejoin_replay")


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=[pytest.mark.slow] if n in _SLOW_EXAMPLES else []) for n in TWINS])
def test_example_prints_the_jax_example_lines(name):
    """``python -m tpu_paxos_torch.examples.<name> --device cpu`` with
    ``jax`` and ``tpu_paxos`` blocked prints its JAX twin's stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in env.get("PYTHONPATH", "").split(
        os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", _BLOCK, f"tpu_paxos_torch.examples.{name}"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == _goldens()["library"]["examples"][TWINS[name]]


def test_replay_diff_replays_a_jax_recorded_log_to_jax_decision_log(tmp_path):
    """The JAX script's wall-paced driver records; the port replays its
    injection log to JAX's decision log byte for byte, and the port's own
    record/replay diff holds."""
    jscript = _script("replay_diff_member")
    tscript = _script("torch_replay_diff_member")
    jms = jscript.wall_clock_driver(seed=11)
    path = str(tmp_path / "injections.json")
    jms.save_injections(path)
    from tpu_paxos_torch.membership.engine import MemberSim

    assert MemberSim.replay(path, device="cpu").decision_log() == jms.decision_log()
    assert tscript.main(["--device", "cpu"]) == 0


def test_check_smoke_engines_hold_on_the_cpu():
    """Each engine's tiny config holds its invariants (the smoke's own
    asserts) and yields a decision log."""
    shas = _script("torch_check_smoke").run_engines("cpu")
    assert sorted(shas) == ["fast", "member", "serve", "sharded", "sim"]
    assert all(len(v) == 64 for v in shas.values())
