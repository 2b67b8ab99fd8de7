"""paxlint's CLI on the port (``python -m tpu_paxos_torch lint``): every
case of ``tests/test_paxlint_cli.py`` mirrored — the JSON report's schema
and findings, exit codes, ``--rules``, stale baselines, the ``--fix``
surface — and the torch-free import guard: the lint runs with ``torch``,
``jax`` and ``tpu_paxos`` blocked."""

import json
import os
import subprocess
import sys
import textwrap

from tpu_paxos.analysis import lint as jlint
from tpu_paxos.analysis import rules_ctl as _jctl  # noqa: F401  (registers RULES)
from tpu_paxos.analysis import rules_det as _jdet  # noqa: F401
from tpu_paxos.analysis import rules_jax as _jjax  # noqa: F401
from tpu_paxos.analysis import rules_shard as _jshard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: One finding per port family (DET001, DET003, DET004, JAX103, CTL001,
#: SH001) and one pragma.
FIXTURE = '''\
"""paxlint golden fixture on the port: one finding per family + one pragma."""
import json
import time

import torch


def set_flags():
    torch.backends.cuda.matmul.allow_tf32 = True


def emit(stream, summary, members):
    stream.write(f"[{time.time()}] start")
    for m in set(members):
        stream.write(str(m))
    print(json.dumps(summary))


def drive(st, dc):
    for _ in range(3):
        st.t.item()
    return dc["cause_id"] == 2


def block(x, rank, step):
    return x[rank * step:(rank + 1) * step]


def allowed(st):
    while st.t.item() < 3:  # paxlint: allow[JAX103] demo suppression
        st = st.step()
'''

WANT = [
    ("DET004", 9, 4), ("DET001", 13, 21), ("DET003", 14, 13), ("JAX103", 21, 8),
    ("CTL001", 22, 11), ("SH001", 26, 13),
]


def _env():
    from _subproc import scrubbed_env

    return scrubbed_env()


def _lint(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "tpu_paxos_torch", "lint", *args],
        capture_output=True, text=True, timeout=120, cwd=cwd, env=_env(),
    )


def test_cli_golden_json(tmp_path):
    (tmp_path / "fixture.py").write_text(FIXTURE)
    p = _lint(["--json", "--no-baseline", "--root", str(tmp_path), "fixture.py"], cwd=REPO)
    assert p.returncode == 1, p.stderr[-2000:]  # findings present
    got = json.loads(p.stdout)
    # JAX's schema, key for key, on the same kind of run
    jrep = jlint.run_lint(root=str(tmp_path), paths=["fixture.py"], baseline_path=None)
    assert sorted(got) == sorted(jrep)
    assert all(sorted(f) == sorted(jrep["findings"][0]) for f in got["findings"])
    assert [(f["rule"], f["line"], f["col"]) for f in got["findings"]] == WANT
    assert got["counts"] == {"CTL001": 1, "DET001": 1, "DET003": 1, "DET004": 1,
                             "JAX103": 1, "SH001": 1}
    assert (got["version"], got["files"], got["baselined"], got["stale_baseline"],
            got["ok"]) == (1, 1, 0, [], False)


def test_cli_repo_is_clean_and_exits_zero():
    p = _lint([], cwd=REPO)
    assert p.returncode == 0, p.stdout + p.stderr[-2000:]
    assert "0 findings" in p.stdout


def test_cli_rules_listing():
    p = _lint(["--rules"], cwd=REPO)
    assert p.returncode == 0
    for rid in ("DET001", "DET002", "DET003", "DET004", "JAX103", "CTL001", "SH001"):
        assert rid in p.stdout
    for rid in ("JAX101", "JAX102", "JAX104"):
        assert rid not in p.stdout


def test_cli_stale_baseline_fails(tmp_path):
    pkg = tmp_path / "tpu_paxos_torch"
    pkg.mkdir()
    (pkg / "clean.py").write_text("x = 1\n")
    stale = tmp_path / "baseline.json"
    stale.write_text(json.dumps({
        "version": 1,
        "entries": [{"rule": "DET001", "file": "tpu_paxos_torch/gone.py", "count": 3}],
    }))
    p = _lint(["--root", str(tmp_path), "--baseline", str(stale)], cwd=REPO)
    assert p.returncode == 1
    assert "stale" in p.stdout


def test_cli_missing_path_exits_2(tmp_path):
    p = _lint(["--root", str(tmp_path), "no_such.py"], cwd=REPO)
    assert p.returncode == 2
    assert "does not exist" in p.stdout


TORCHFREE_DRIVER = textwrap.dedent("""\
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "tpu_paxos", "torch"):
                raise ImportError("blocked in paxlint: " + name)
            return None

    for m in [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "tpu_paxos", "torch")]:
        del sys.modules[m]
    sys.meta_path.insert(0, Block())
    from tpu_paxos_torch.analysis import artifact_schema, lint, registry, rules_det, rules_torch
    report = lint.run_lint(root="@@ROOT@@", paths=["tpu_paxos_torch/analysis"])
    assert report["ok"], report
    assert len(registry.AUDIT_PROVIDERS) == 14
    print("TORCHFREE_OK", report["files"])
""")


def test_analysis_imports_and_lints_without_jax():
    p = subprocess.run(
        [sys.executable, "-c", TORCHFREE_DRIVER.replace("@@ROOT@@", REPO)],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=_env(),
    )
    assert p.returncode == 0, p.stderr[-3000:]
    assert "TORCHFREE_OK" in p.stdout


# ---------------- --fix scaffolding (CLI surface) ----------------

FIX_FIXTURE = '''\
import time


def emit(stream, members):
    for m in set(members):
        stream.write(str(m))
    stream.write(str(time.time()))
'''


def test_cli_fix_dry_run_prints_diff_and_leaves_tree(tmp_path):
    (tmp_path / "fixture.py").write_text(FIX_FIXTURE)
    p = _lint(["--fix", "--no-baseline", "--root", str(tmp_path), "fixture.py"], cwd=REPO)
    assert p.returncode == 1, p.stderr[-2000:]
    assert "+    for m in sorted(set(members)):" in p.stdout
    assert "+    # paxlint: allow[DET001]" in p.stdout
    assert "dry run" in p.stdout
    assert (tmp_path / "fixture.py").read_text() == FIX_FIXTURE


def test_cli_fix_write_applies_and_relints_clean(tmp_path):
    (tmp_path / "fixture.py").write_text(FIX_FIXTURE)
    p = _lint(["--fix", "--write", "--no-baseline", "--root", str(tmp_path), "fixture.py"],
              cwd=REPO)
    assert p.returncode == 1, p.stderr[-2000:]
    assert "fixed: fixture.py" in p.stdout
    fixed = (tmp_path / "fixture.py").read_text()
    assert "sorted(set(members))" in fixed
    assert "# paxlint: allow[DET001] TODO:" in fixed
    p = _lint(["--no-baseline", "--root", str(tmp_path), "fixture.py"], cwd=REPO)
    assert p.returncode == 0, p.stdout + p.stderr[-2000:]
    assert "0 findings" in p.stdout


def test_cli_write_without_fix_is_an_error(tmp_path):
    p = _lint(["--write", "--root", str(tmp_path)], cwd=REPO)
    assert p.returncode == 2
    assert "--write requires --fix" in p.stderr


def test_cli_fix_with_json_is_an_error(tmp_path):
    p = _lint(["--fix", "--json", "--root", str(tmp_path)], cwd=REPO)
    assert p.returncode == 2
    assert "--fix does not support --json" in p.stderr
