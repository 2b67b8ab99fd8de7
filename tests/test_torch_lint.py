"""paxlint on the port (``tpu_paxos_torch/analysis/lint.py``): every case
of ``tests/test_paxlint.py`` mirrored on the port's engine and rule
families, and the port's engine held against JAX's on shared fixtures.

Each fixture is a tiny source snippet linted through ``lint_source``
(``replay_critical=True`` puts the DET rules in scope without a package
on disk).  Where JAX's rule is about tracing (JAX101, JAX102, JAX104) the
port has no counterpart: the mirror asserts that the same fixture gives
the port no finding.  DET002 and DET004 gain torch's global generator and
global settings; SH001 becomes the hand-made rank split or gather."""

import json
import os

import pytest

from tpu_paxos.analysis import lint as jlint
from tpu_paxos.analysis import rules_ctl as _jctl  # noqa: F401  (registers RULES)
from tpu_paxos.analysis import rules_det as _jdet  # noqa: F401
from tpu_paxos.analysis import rules_jax as _jjax  # noqa: F401
from tpu_paxos.analysis import rules_shard as _jshard  # noqa: F401
from tpu_paxos_torch.analysis import lint
from tpu_paxos_torch.analysis import rules_ctl  # noqa: F401  (registers RULES)
from tpu_paxos_torch.analysis import rules_det  # noqa: F401
from tpu_paxos_torch.analysis import rules_shard  # noqa: F401
from tpu_paxos_torch.analysis import rules_torch  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rules_of(src: str, **kw) -> list[str]:
    return [f.rule for f in lint.lint_source(src, **kw)]


@pytest.fixture(scope="module")
def repo_reports():
    """The two full-repo lint runs the contract tests share: with the
    committed baseline and without it."""
    return lint.run_lint(root=REPO), lint.run_lint(root=REPO, baseline_path=None)


# ---------------- DET001: wall-clock ----------------

def test_det001_true_positive_replay_critical():
    src = "import time\n\ndef stamp():\n    return time.time()\n"
    assert rules_of(src) == ["DET001"]


def test_det001_true_positive_sink_function_outside_closure():
    src = (
        "import time\n\n"
        "def log_line(stream, msg):\n"
        "    stream.write(f'[{time.time()}] {msg}')\n"
    )
    assert rules_of(src, replay_critical=False) == ["DET001"]


def test_det001_true_negative_outside_scope():
    src = (
        "import time\n\n"
        "def elapsed():\n    return time.perf_counter()\n"
    )
    assert rules_of(src, replay_critical=False) == []


# ---------------- DET002: unseeded randomness ----------------

def test_det002_true_positive():
    src = (
        "import random\n\n"
        "def backoff():\n    return random.random()\n"
    )
    assert rules_of(src) == ["DET002"]


def test_det002_legacy_numpy_global_flagged():
    src = "import numpy as np\n\ndef f():\n    return np.random.rand(3)\n"
    assert rules_of(src) == ["DET002"]


def test_det002_true_negative_seeded():
    # the sanctioned patterns: utils/prng streams, seeded Generators
    # (numpy's and torch's), torch samplers given their own generator
    src = (
        "import numpy as np\nimport torch\n"
        "from tpu_paxos_torch.utils import prng\n\n"
        "def f(seed):\n"
        "    k = prng.fold_in(prng.root_key(seed), 3)\n"
        "    g = torch.Generator().manual_seed(seed)\n"
        "    x = torch.rand(4, generator=g)\n"
        "    return k, x, np.random.default_rng(seed)\n"
    )
    assert rules_of(src) == []


@pytest.mark.parametrize("call", [
    "torch.rand(3)", "torch.randn(2, 2)", "torch.randint(0, 9, (4,))",
    "torch.randperm(5)", "torch.manual_seed(0)", "torch.Generator()",
    "torch.bernoulli(p)",
])
def test_det002_torch_global_generator_flagged(call):
    src = f"import torch\n\ndef f(p):\n    return {call}\n"
    assert rules_of(src) == ["DET002"]


# ---------------- DET003: unordered iteration ----------------

def test_det003_true_positive_set_iteration():
    src = (
        "def log_members(members):\n"
        "    return ' '.join(str(m) for m in set(members))\n"
    )
    assert rules_of(src) == ["DET003"]


def test_det003_repo_idiom_set_accessor():
    src = (
        "def dump(sim):\n"
        "    return [x for x in sim.acceptor_set()]\n"
    )
    assert rules_of(src) == ["DET003"]


def test_det003_true_negative_sorted():
    src = (
        "def log_members(members):\n"
        "    return ' '.join(str(m) for m in sorted(set(members)))\n"
    )
    assert rules_of(src) == []


def test_det003_true_negative_order_insensitive():
    src = (
        "def f(a, b):\n"
        "    return len(set(a) & set(b)), min(set(a)), 3 in set(b)\n"
    )
    assert rules_of(src) == []


def test_det003_dataflow_set_through_local():
    src = (
        "def emit(out, xs):\n"
        "    s = set(xs)\n"
        "    for x in s:\n"
        "        out.write(str(x))\n"
    )
    findings = lint.lint_source(src)
    assert [f.rule for f in findings] == ["DET003"]
    assert "set-typed by assignment" in findings[0].message


def test_det003_dataflow_chained_local():
    src = (
        "def emit(out, xs):\n"
        "    s = set(xs)\n"
        "    t = s\n"
        "    for x in t:\n"
        "        out.write(str(x))\n"
    )
    assert rules_of(src) == ["DET003"]


def test_det003_dataflow_true_negative_sorted_assignment():
    src = (
        "def emit(out, xs):\n"
        "    s = sorted(set(xs))\n"
        "    for x in s:\n"
        "        out.write(str(x))\n"
    )
    assert rules_of(src) == []


def test_det003_dataflow_true_negative_reassigned():
    src = (
        "def emit(out, xs):\n"
        "    s = set(xs)\n"
        "    s = list(range(3))\n"
        "    for x in s:\n"
        "        out.write(str(x))\n"
    )
    assert rules_of(src) == []


def test_det003_dataflow_true_negative_loop_target():
    src = (
        "def emit(out, xs):\n"
        "    s = set(xs)\n"
        "    for s in ([1], [2]):\n"
        "        for x in s:\n"
        "            out.write(str(x))\n"
    )
    assert rules_of(src) == []


def test_det003_dataflow_set_local_sorted_at_site():
    src = (
        "def emit(out, xs):\n"
        "    s = set(xs)\n"
        "    for x in sorted(s):\n"
        "        out.write(str(x))\n"
    )
    assert rules_of(src) == []


def test_det003_dataflow_augassign_preserves_set_kind():
    src = (
        "def emit(out, xs, ys):\n"
        "    s = set(xs)\n"
        "    s |= set(ys)\n"
        "    for x in s:\n"
        "        out.write(str(x))\n"
    )
    assert rules_of(src) == ["DET003"]


def test_det003_dataflow_dict_view_through_local_in_sink():
    src = (
        "import json\n\n"
        "def emit(summary):\n"
        "    view = summary.items()\n"
        "    print(json.dumps([k for k, v in view]))\n"
    )
    assert "DET003" in rules_of(src, replay_critical=False)


def test_det003_dataflow_true_negative_param_shadow():
    src = (
        "def emit(out, xs, s=None):\n"
        "    if s is None:\n"
        "        s = set(xs)\n"
        "    for x in s:\n"
        "        out.write(str(x))\n"
    )
    assert rules_of(src) == []


def test_det003_dataflow_scopes_are_separate():
    src = (
        "def a(out, xs):\n"
        "    s = set(xs)\n"
        "    return len(s)\n\n"
        "def b(out, s):\n"
        "    for x in s:\n"
        "        out.write(str(x))\n"
    )
    assert rules_of(src) == []


def test_det003_dict_view_in_sink():
    src = (
        "import json\n\n"
        "def emit(summary):\n"
        "    print(json.dumps({k: v for k, v in summary.items()}))\n"
    )
    assert "DET003" in rules_of(src, replay_critical=False)


def test_det003_dict_view_ok_outside_sink():
    src = (
        "def total(d):\n"
        "    out = 0\n"
        "    for k, v in d.items():\n        out += v\n"
        "    return out\n"
    )
    assert rules_of(src) == []


# ---------------- DET004: global torch settings ----------------

def test_det004_true_positive_anywhere():
    # JAX's fixture (jax.config.update) as torch's global settings
    src = (
        "import torch\n\n"
        "def setup():\n"
        "    torch.backends.cuda.matmul.allow_tf32 = True\n"
        "    torch.set_default_dtype(torch.float64)\n"
        "    torch.cuda.set_sync_debug_mode('warn')\n"
    )
    assert rules_of(src, replay_critical=False) == ["DET004"] * 3


def test_det004_true_negative_in_device_module(tmp_path):
    # the one sanctioned home; exercised on a real path layout
    pkg = tmp_path / "tpu_paxos_torch" / "utils"
    pkg.mkdir(parents=True)
    (pkg / "device.py").write_text(
        "import torch\ntorch.backends.cudnn.benchmark = False\n"
        "torch.use_deterministic_algorithms(True)\n"
    )
    findings = lint.lint_files(str(tmp_path), ["tpu_paxos_torch/utils/device.py"])
    assert [f.rule for f in findings] == []


# ---------------- JAX101/102/104: no torch counterpart ----------------

JIT_IF = (
    "import jax\n\n"
    "@jax.jit\n"
    "def step(state):\n"
    "    if state > 0:\n        return state\n"
    "    return -state\n"
)


def test_jax101_true_positive_decorator():
    # JAX flags this trace-time branch; the port traces nothing
    assert [f.rule for f in jlint.lint_source(JIT_IF, replay_critical=False)] == ["JAX101"]
    assert rules_of(JIT_IF, replay_critical=False) == []


def test_jax101_true_positive_lax_body():
    src = (
        "import jax\n\n"
        "def outer(st0):\n"
        "    def body(st):\n"
        "        while st < 4:\n            st = st + 1\n"
        "        return st\n"
        "    return jax.lax.while_loop(lambda s: s < 10, body, st0)\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax101_true_negative_static_argnames():
    src = (
        "import jax\n\n"
        "def choose(state, quorum):\n"
        "    if quorum > 1:\n        return state\n"
        "    return -state\n\n"
        "choose_jit = jax.jit(choose, static_argnames=('quorum',))\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax101_true_negative_shape_and_none_tests():
    src = (
        "import jax\n\n"
        "@jax.jit\n"
        "def f(x, y=None):\n"
        "    if x.ndim > 1 and y is None:\n        return x.sum()\n"
        "    return x\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax102_true_positive_module_mutable():
    src = (
        "import jax\n\n"
        "SCALE = [2.0]\n\n"
        "@jax.jit\n"
        "def f(x):\n    return x * SCALE[0]\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax102_true_positive_global_stmt():
    src = (
        "import jax\n\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    global counter\n"
        "    return x\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax101_nested_helper_inside_jit_is_traced():
    src = (
        "import jax\n\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    def inner(y):\n"
        "        if y > 0:\n            return y\n"
        "        return -y\n"
        "    return inner(x)\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax102_true_negative_immutable_capture():
    src = (
        "import jax\n\n"
        "SCALES = (2.0, 3.0)\nNAMES = ['a']\n\n"
        "@jax.jit\n"
        "def f(x):\n    return x * SCALES[0]\n\n"
        "def host():\n    return NAMES[0]\n"
    )
    assert rules_of(src, replay_critical=False) == []


# ---------------- JAX103: host sync in a host loop ----------------

def test_jax103_true_positive():
    src = (
        "import numpy as np\n\n"
        "def drive(sim):\n"
        "    for _ in range(100):\n"
        "        sim.state = sim.step()\n"
        "        if np.asarray(sim.state.done):\n            break\n"
    )
    assert rules_of(src, replay_critical=False) == ["JAX103"]


def test_jax103_true_positive_item():
    src = (
        "def drive(steps, st):\n"
        "    while st.t.item() < 10:\n        st = step(st)\n"
    )
    assert rules_of(src, replay_critical=False) == ["JAX103"]


@pytest.mark.parametrize("sync", [
    "x = st.done.cpu()", "torch.cuda.synchronize()", "v = st.t.tolist()",
])
def test_jax103_torch_syncs_flagged(sync):
    src = (
        "import torch\n\n"
        f"def drive(st):\n    for _ in range(4):\n        {sync}\n"
    )
    assert rules_of(src, replay_critical=False) == ["JAX103"]


def test_jax103_true_negative_hoisted_and_host_lists():
    src = (
        "import numpy as np\n\n"
        "def drive(sim, workload):\n"
        "    for w in workload:\n"
        "        sim.push(np.asarray(w, np.int32))\n"
        "        rows = w.tolist()\n"
        "    return np.asarray(sim.state.done)\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax103_loop_else_runs_once():
    src = (
        "def drive(sim):\n"
        "    for _ in range(100):\n"
        "        sim.push()\n"
        "    else:\n"
        "        final = sim.state.x.item()\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax103_for_iter_evaluates_once():
    src = (
        "import numpy as np\n\n"
        "def scan(st):\n"
        "    for v in np.asarray(st.own_assign):\n"
        "        use(v)\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax104_true_positive():
    src = (
        "import jax\nimport jax.numpy as jnp\n\n"
        "@jax.jit\n"
        "def init(n):\n    return jnp.zeros(n)\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax104_true_negative_with_static():
    src = (
        "import jax\nimport jax.numpy as jnp\n\n"
        "def init(n):\n    return jnp.zeros(n)\n\n"
        "init_jit = jax.jit(init, static_argnames=('n',))\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax101_static_declaration_survives_double_marking():
    src = (
        "import jax\n\n"
        "def step(st, n):\n"
        "    if n > 0:\n        return st\n"
        "    return -st\n\n"
        "step_jit = jax.jit(step, static_argnames=('n',))\n"
        "def outer(st0):\n"
        "    return jax.lax.while_loop(lambda s: s[1] < 3, step, st0)\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_jax104_lax_bodies_exempt():
    src = (
        "import jax\n\n"
        "def outer(st0):\n"
        "    return jax.lax.while_loop(lambda s: s < 10,\n"
        "                              lambda s: s + 1, st0)\n"
    )
    assert rules_of(src, replay_critical=False) == []


# ---------------- CTL001: raw cause-code literals ----------------

def test_ctl001_true_positive_subscript_key():
    src = (
        "def is_gray(dc):\n"
        "    return dc['cause_id'] == 2\n"
    )
    assert rules_of(src, replay_critical=False) == ["CTL001"]


def test_ctl001_true_positive_membership():
    src = (
        "def vetoed(dc):\n"
        "    return 2 in dc['cause_ids']\n"
    )
    assert rules_of(src, replay_critical=False) == ["CTL001"]


def test_ctl001_true_positive_call_result():
    src = (
        "from tpu_paxos_torch.telemetry import diagnose as diag\n\n"
        "def f(name):\n"
        "    return diag.cause_code(name) != 3\n"
    )
    assert rules_of(src, replay_critical=False) == ["CTL001"]


def test_ctl001_true_negative_named_lookup():
    src = (
        "from tpu_paxos_torch.telemetry import diagnose as diag\n\n"
        "def is_gray(dc):\n"
        "    return dc['cause_id'] == diag.CAUSE_IDS['gray-region']\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_ctl001_true_negative_unrelated_int_compare():
    src = (
        "def f(dc):\n"
        "    return dc['level'] == 2 and len(dc['windows']) > 0\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_ctl001_true_negative_bool_literal():
    src = (
        "def f(dc):\n"
        "    return dc['cause_known'] == True  # noqa: E712\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_ctl001_exempt_in_table_owner(tmp_path):
    src = "CAUSE_IDS = {'unknown': 0}\nOK = CAUSE_IDS['unknown'] == 0\n"
    assert rules_of(src, replay_critical=False,
                    path="tpu_paxos_torch/telemetry/diagnose.py") == []


# ---------------- SH001: rank splits stay in parallel/ ----------------

def test_sh001_true_positive_partitionspec_import():
    # the rank block sliced by hand
    src = (
        "def block(x, rank, step):\n"
        "    return x[rank * step:(rank + 1) * step]\n"
    )
    assert rules_of(src, replay_critical=False) == ["SH001"]


def test_sh001_true_positive_raw_shard_map_import():
    # both spellings of a split into the mesh's rank blocks
    src = "import torch\n\ndef f(x, mesh):\n    return torch.chunk(x, mesh.size)\n"
    assert rules_of(src, replay_critical=False) == ["SH001"]
    src = "def f(x, comm):\n    return x.tensor_split(comm.size)\n"
    assert rules_of(src, replay_critical=False) == ["SH001"]


def test_sh001_true_positive_dotted_reference():
    # a gather of a mesh run's outputs by hand
    src = (
        "import torch\n\n"
        "def gather(mesh, fn):\n"
        "    return torch.cat(mesh.run(fn))\n"
    )
    assert rules_of(src, replay_critical=False) == ["SH001"]


def test_sh001_true_negative_table_and_mesh_surface():
    src = (
        "from tpu_paxos_torch.parallel import mesh as pmesh\n\n"
        "def tile(mesh, fn, dev, tree):\n"
        "    outs = pmesh.on_lanes(mesh, 'fleet', fn, dev, tree)\n"
        "    return pmesh.gather_lanes(mesh, 'fleet', outs)\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_sh001_true_negative_unrelated_jax_sharding_import():
    # a split that is not into a mesh's rank blocks is not the smell
    src = (
        "import numpy as np\n\n"
        "def f(vids, cut, x):\n"
        "    return np.split(vids, cut), x[: len(x) // 2]\n"
    )
    assert rules_of(src, replay_critical=False) == []


def test_sh001_exempt_in_parallel_owner():
    src = (
        "def block(x, rank, step):\n"
        "    return x[rank * step:(rank + 1) * step]\n"
    )
    assert rules_of(src, replay_critical=False,
                    path="tpu_paxos_torch/parallel/mesh.py") == []


def test_sh001_pragma_suppresses():
    src = (
        "def block(x, rank, step):\n"
        "    return x[rank * step:]  # paxlint: allow[SH001] fixture slices a rank block\n"
    )
    assert rules_of(src, replay_critical=False) == []


# ---------------- pragmas ----------------

def test_pragma_same_line():
    src = (
        "import time\n\n"
        "def stamp():\n"
        "    return time.time()  # paxlint: allow[DET001] zeroed later\n"
    )
    assert rules_of(src) == []


def test_pragma_standalone_line_above():
    src = (
        "import time\n\n"
        "def stamp():\n"
        "    # paxlint: allow[DET001] zeroed in deterministic mode\n"
        "    return time.time()\n"
    )
    assert rules_of(src) == []


def test_pragma_wrong_rule_does_not_suppress():
    src = (
        "import time\n\n"
        "def stamp():\n"
        "    return time.time()  # paxlint: allow[DET002]\n"
    )
    assert rules_of(src) == ["DET001"]


def test_pragma_star_suppresses_all():
    src = (
        "import time\n\n"
        "def stamp():\n"
        "    return time.time()  # paxlint: allow[*] legacy\n"
    )
    assert rules_of(src) == []


# ---------------- baseline mechanics ----------------

def test_baseline_consumes_findings():
    f = lint.Finding("DET001", "a.py", 3, 0, "m", "h")
    remaining, stale = lint.apply_baseline([f, f], {("DET001", "a.py"): 2})
    assert remaining == [] and stale == []


def test_baseline_stale_entry_reported():
    remaining, stale = lint.apply_baseline([], {("DET001", "a.py"): 2})
    assert remaining == []
    assert stale == [{"rule": "DET001", "file": "a.py", "unused": 2}]


def test_baseline_undercount_leaves_findings():
    f = lint.Finding("DET001", "a.py", 3, 0, "m", "h")
    remaining, stale = lint.apply_baseline([f, f], {("DET001", "a.py"): 1})
    assert len(remaining) == 1 and stale == []


def test_path_scoped_run_skips_out_of_selection_baseline(tmp_path):
    (tmp_path / "clean.py").write_text("x = 1\n")
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({
        "version": 1,
        "entries": [{"rule": "JAX103", "file": "elsewhere.py", "count": 1}],
    }))
    report = lint.run_lint(root=str(tmp_path), paths=["clean.py"], baseline_path=str(bl))
    assert report["ok"], report
    assert report["stale_baseline"] == []
    full = lint.run_lint(root=str(tmp_path), baseline_path=str(bl))
    assert not full["ok"] and full["stale_baseline"]


def test_repo_path_scoped_lint_is_clean():
    report = lint.run_lint(root=REPO, paths=["tpu_paxos_torch/core"])
    assert report["ok"], json.dumps(report, indent=1)


def test_overlapping_paths_lint_each_file_once():
    report = lint.run_lint(
        root=REPO, paths=["tpu_paxos_torch/membership",
                          "tpu_paxos_torch/membership/engine.py"]
    )
    assert report["ok"], json.dumps(report, indent=1)
    assert report["files"] == len(lint.walk_files(REPO, ["tpu_paxos_torch/membership"]))


def test_missing_path_fails_loudly(tmp_path):
    with pytest.raises(FileNotFoundError):
        lint.run_lint(root=str(tmp_path), paths=["no_such_file.py"])


# ---------------- the port ships clean, baseline exact ----------------

@pytest.mark.parametrize("use_baseline", [True, False])
def test_repo_lint_contract(use_baseline, repo_reports):
    """The committed port has zero unsuppressed findings and the
    committed baseline is EXACT: every entry is a live finding."""
    with_bl, without = repo_reports
    assert with_bl["ok"], json.dumps(with_bl, indent=1)
    assert with_bl["findings"] == []
    assert with_bl["stale_baseline"] == []
    if use_baseline:
        return
    assert len(without["findings"]) == with_bl["baselined"]
    committed = lint.load_baseline(lint.DEFAULT_BASELINE)
    got: dict = {}
    for f in without["findings"]:
        got[(f["rule"], f["file"])] = got.get((f["rule"], f["file"]), 0) + 1
    assert got == committed


def test_baseline_entries_carry_reasons():
    with open(lint.DEFAULT_BASELINE) as fh:
        entries = json.load(fh)["entries"]
    assert all(e.get("reason") for e in entries), entries
    # the package itself carries no debt: its exceptions are pragmas
    assert not [e for e in entries if e["file"].startswith("tpu_paxos_torch/")]


def test_default_scope_is_the_port_only():
    files = lint.walk_files(REPO)
    assert "chip_smoke.py" in files
    assert any(f.startswith("tpu_paxos_torch/") for f in files)
    assert not any(f.startswith("tpu_paxos/") for f in files)
    tests = [f for f in files if f.startswith("tests/")]
    assert tests and all(os.path.basename(f).startswith("test_torch_") for f in tests)
    scripts = [f for f in files if f.startswith("scripts/")]
    assert all(os.path.basename(f).startswith("torch_") for f in scripts)


def test_replay_closure_includes_log_via_package_init():
    """core/sim.py imports tpu_paxos_torch.utils.prng, which executes
    utils/__init__.py: the package init is replay-critical, and so is
    what the roots import lazily."""
    files = lint.walk_files(REPO)
    closure = lint.replay_closure(files, REPO)
    assert "tpu_paxos_torch.utils" in closure
    assert "tpu_paxos_torch.core.sim" in closure
    assert "tpu_paxos_torch.fleet.evolve" in closure
    # the lazy imports inside functions count: shrink and evolve pull in
    # the fleet runner and the search, as JAX's closure has them
    assert "tpu_paxos_torch.fleet.runner" in closure
    assert "tpu_paxos_torch.fleet.search" in closure
    assert "tpu_paxos_torch.analysis.lint" not in closure


def test_replay_closure_matches_jax_module_for_module():
    """The port's closure holds the counterpart of every JAX module in
    JAX's closure that the port has."""
    jfiles = jlint.walk_files(REPO, ["tpu_paxos"])
    jclosure = jlint.replay_closure(jfiles, REPO)
    pclosure = lint.replay_closure(lint.walk_files(REPO), REPO)
    port_mods = {lint.module_name(f) for f in lint.walk_files(REPO)}
    for m in sorted(jclosure):
        twin = "tpu_paxos_torch" + m[len("tpu_paxos"):]
        if twin in port_mods:
            assert twin in pclosure, twin


def test_every_rule_documented():
    assert set(lint.RULES) == {
        "CTL001",
        "DET001", "DET002", "DET003", "DET004",
        "JAX103",
        "SH001",
    }


# ---------------- the port's engine against JAX's ----------------

#: Fixtures whose rules mean the same on both engines (DET001-003, CTL001,
#: JAX103), with ``tpu_paxos`` names mapped to the port's.
SHARED = {
    "det001_closure": ("import time\n\ndef stamp():\n    return time.time()\n", True),
    "det001_sink": ("import time\n\ndef log_line(stream, msg):\n"
                    "    stream.write(f'[{time.time()}] {msg}')\n", False),
    "det002_random": ("import random\n\ndef backoff():\n    return random.random()\n", True),
    "det002_numpy": ("import numpy as np\n\ndef f(seed):\n"
                     "    return np.random.rand(3), np.random.default_rng(seed)\n", True),
    "det003_mixed": ("import json\n\ndef emit(out, xs, summary):\n    s = set(xs)\n"
                     "    for x in s:\n        out.write(str(x))\n"
                     "    print(json.dumps([k for k, v in summary.items()]))\n"
                     "    return len(s), sorted(s)\n", False),
    "det003_accessor": ("def dump(sim):\n    return [x for x in sim.acceptor_set()]\n", True),
    "ctl001": ("from tpu_paxos.telemetry import diagnose as diag\n\n"
               "def f(dc, name):\n    return (dc['cause_id'] == 2, 2 in dc['cause_ids'],\n"
               "            diag.cause_code(name) != 3, dc['level'] == 2)\n", False),
    "jax103": ("import numpy as np\n\ndef drive(sim, workload):\n"
               "    for w in workload:\n        sim.push(np.asarray(w))\n"
               "        if np.asarray(sim.state.done):\n            break\n"
               "    while sim.t.item() < 10:\n        sim.step()\n"
               "    else:\n        last = sim.state.x.item()\n", False),
    "pragmas": ("import time\n\ndef stamp():\n"
                "    # paxlint: allow[DET001] zeroed\n    a = time.time()\n"
                "    return a, time.time()  # paxlint: allow[DET002]\n", True),
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_findings_equal_jax_on_shared_fixtures(name):
    src, critical = SHARED[name]
    jf = jlint.lint_source(src, path="fixture.py", replay_critical=critical)
    pf = lint.lint_source(src.replace("tpu_paxos.", "tpu_paxos_torch."), path="fixture.py",
                          replay_critical=critical)
    assert [(f.rule, f.line, f.col) for f in pf] == [(f.rule, f.line, f.col) for f in jf]
    assert jf, "the shared fixture must give findings to compare"


def test_ctl001_owner_maps_to_the_port():
    src = "CAUSE_IDS = {'unknown': 0}\nOK = CAUSE_IDS['unknown'] == 0\n"
    assert [f.rule for f in jlint.lint_source(src, replay_critical=False,
                                              path="tpu_paxos/telemetry/diagnose.py")] == []
    # JAX's owner path is not the port's: the port flags it there
    assert rules_of(src, replay_critical=False,
                    path="tpu_paxos/telemetry/diagnose.py") == ["CTL001"]


# ---------------- --fix scaffolding (analysis/fix.py) ----------------

def _plan(tmp_path, src):
    from tpu_paxos_torch.analysis import fix

    (tmp_path / "pkg").mkdir(exist_ok=True)
    (tmp_path / "pkg" / "mod.py").write_text(src)
    report = lint.run_lint(root=str(tmp_path), paths=["pkg/mod.py"], baseline_path=None)
    return report, fix.plan_fixes(report, str(tmp_path))


def _fixed_text(plans):
    return plans["pkg/mod.py"][1]


def _relint(tmp_path, path="pkg/mod.py"):
    return lint.run_lint(root=str(tmp_path), paths=[path], baseline_path=None)


def test_fix_det003_wraps_iteration_in_sorted(tmp_path):
    from tpu_paxos_torch.analysis import fix

    src = (
        "def emit(items):\n"
        "    s = set(items)\n"
        "    out = []\n"
        "    for x in s:\n"
        "        out.append(x)\n"
        "    print(out)\n"
    )
    report, plans = _plan(tmp_path, src)
    assert [f["rule"] for f in report["findings"]] == ["DET003"]
    assert "    for x in sorted(s):\n" in _fixed_text(plans)
    fix.apply_fixes(plans, str(tmp_path))
    assert _relint(tmp_path)["findings"] == []


def test_fix_det003_wraps_whole_dict_view_call(tmp_path):
    src = (
        "import json\n\n"
        "def dump(stream, d):\n"
        "    for k, v in d.items():\n"
        "        stream.write(json.dumps([k, v]))\n"
    )
    _report, plans = _plan(tmp_path, src)
    assert "    for k, v in sorted(d.items()):\n" in _fixed_text(plans)


def test_fix_det003_multiline_expression(tmp_path):
    import ast

    src = (
        "def emit(items, extra):\n"
        "    for x in set(\n"
        "        items + extra\n"
        "    ):\n"
        "        print(x)\n"
    )
    _report, plans = _plan(tmp_path, src)
    fixed = _fixed_text(plans)
    assert "    for x in sorted(set(\n" in fixed
    assert "    )):\n" in fixed
    ast.parse(fixed)


def test_fix_pragma_scaffold_indented_with_todo(tmp_path):
    from tpu_paxos_torch.analysis import fix

    src = (
        "import time\n\n"
        "def log_line(stream, msg):\n"
        "    stream.write(f'[{time.time()}] {msg}')\n"
    )
    report, plans = _plan(tmp_path, src)
    assert [f["rule"] for f in report["findings"]] == ["DET001"]
    assert (
        "    # paxlint: allow[DET001] " + fix.TODO_REASON + "\n"
        "    stream.write(f'[{time.time()}] {msg}')\n"
    ) in _fixed_text(plans)
    fix.apply_fixes(plans, str(tmp_path))
    assert _relint(tmp_path)["findings"] == []


def test_fix_true_negative_clean_file_no_plans(tmp_path):
    from tpu_paxos_torch.analysis import fix

    report, plans = _plan(tmp_path, "def ok(xs):\n    return sorted(set(xs))\n")
    assert report["findings"] == []
    assert plans == {}
    assert fix.render_diff(plans) == ""


def test_fix_mixed_findings_apply_bottom_up(tmp_path):
    from tpu_paxos_torch.analysis import fix

    src = (
        "import time\n\n"
        "def emit(items):\n"
        "    s = set(items)\n"
        "    for x in s:\n"
        "        print(x)\n"
        "    print(time.time())\n"
    )
    _report, plans = _plan(tmp_path, src)
    fixed = _fixed_text(plans)
    assert "    for x in sorted(s):\n" in fixed
    assert "    # paxlint: allow[DET001]" in fixed
    fix.apply_fixes(plans, str(tmp_path))
    assert _relint(tmp_path)["findings"] == []


def test_fix_same_line_wrap_and_pragma_do_not_corrupt(tmp_path):
    import ast

    from tpu_paxos_torch.analysis import fix

    src = (
        "import time\n\n"
        "def emit(stream, s):\n"
        "    for x in s & {1}: stream.write(str(time.time()))\n"
    )
    report, plans = _plan(tmp_path, src)
    assert {f["rule"] for f in report["findings"]} == {"DET001", "DET003"}
    fixed = _fixed_text(plans)
    assert "for x in sorted(s & {1}):" in fixed
    assert "    # paxlint: allow[DET001]" in fixed
    ast.parse(fixed)
    fix.apply_fixes(plans, str(tmp_path))
    assert _relint(tmp_path)["findings"] == []


def test_fix_skips_unparseable_file_without_crashing(tmp_path):
    from tpu_paxos_torch.analysis import fix

    (tmp_path / "pkg").mkdir(exist_ok=True)
    (tmp_path / "pkg" / "bad.py").write_text("def broken(:\n")
    (tmp_path / "pkg" / "mod.py").write_text(
        "def emit(xs):\n    for x in set(xs):\n        print(x)\n"
    )
    report = lint.run_lint(root=str(tmp_path), paths=["pkg"], baseline_path=None)
    assert "PARSE" in {f["rule"] for f in report["findings"]}
    plans = fix.plan_fixes(report, str(tmp_path))
    assert set(plans) == {"pkg/mod.py"}


def test_fix_plan_is_dry_run_and_apply_refuses_stale(tmp_path):
    from tpu_paxos_torch.analysis import fix

    src = "import time\n\ndef f(s):\n    s.write(str(time.time()))\n"
    _report, plans = _plan(tmp_path, src)
    path = tmp_path / "pkg" / "mod.py"
    assert path.read_text() == src
    path.write_text(src + "\n# drifted\n")
    with pytest.raises(RuntimeError, match="changed since"):
        fix.apply_fixes(plans, str(tmp_path))


def test_fix_stale_apply_writes_nothing_at_all(tmp_path):
    from tpu_paxos_torch.analysis import fix

    (tmp_path / "pkg").mkdir()
    a = "import time\n\ndef f(s):\n    s.write(str(time.time()))\n"
    b = "import time\n\ndef g(s):\n    s.write(str(time.time()))\n"
    (tmp_path / "pkg" / "a.py").write_text(a)
    (tmp_path / "pkg" / "b.py").write_text(b)
    report = lint.run_lint(root=str(tmp_path), paths=["pkg"], baseline_path=None)
    plans = fix.plan_fixes(report, str(tmp_path))
    assert set(plans) == {"pkg/a.py", "pkg/b.py"}
    (tmp_path / "pkg" / "b.py").write_text(b + "# drifted\n")
    with pytest.raises(RuntimeError, match="b.py changed since"):
        fix.apply_fixes(plans, str(tmp_path))
    assert (tmp_path / "pkg" / "a.py").read_text() == a


def test_fix_never_plans_a_corrupting_rewrite(tmp_path):
    src = (
        "import time\n\n"
        "def f(s):\n"
        "    x = 1 + \\\n"
        "        time.time()\n"
        "    s.write(str(x))\n"
    )
    report, plans = _plan(tmp_path, src)
    assert [f["rule"] for f in report["findings"]] == ["DET001"]
    assert plans == {}
