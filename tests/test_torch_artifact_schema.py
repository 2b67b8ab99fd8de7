"""The port's repro-artifact schema (``tpu_paxos_torch/analysis/
artifact_schema.py``) and artifact loader against the JAX package's: every
case of ``tests/test_artifact_schema.py`` (but the one that reads a
gitignored wedge file) accepts or rejects the same artifact with the same
field path and message, in ``validate_artifact`` and in ``load_artifact``,
and the ``repro`` CLIs print the same exit-2 summary."""

import copy
import importlib.util
import json
import os

import pytest

from tpu_paxos.analysis import artifact_schema as jschema
from tpu_paxos.harness import shrink as jshr
from tpu_paxos_torch.analysis import artifact_schema as tschema
from tpu_paxos_torch.analysis import chunking as tchunk
from tpu_paxos_torch.harness import shrink as tshr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_schema_tests():
    spec = importlib.util.spec_from_file_location(
        "jax_artifact_schema_tests", os.path.join(ROOT, "tests", "test_artifact_schema.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


valid_artifact = _jax_schema_tests().valid_artifact


def _set(path, value):
    """A mutation setting ``art[path...] = value``."""
    def mutate(art):
        node = art
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return mutate


def _delete(*path):
    def mutate(art):
        node = art
        for k in path[:-1]:
            node = node[k]
        del node[path[-1]]
    return mutate


def _rename_nodes(art):
    ep = art["cfg"]["faults"]["schedule"]["episodes"][0]
    ep["node"] = ep.pop("nodes")


EP = ("cfg", "faults", "schedule", "episodes")

# (name, mutation): the cases of tests/test_artifact_schema.py, and a few
# more of the same grammar (serve cross-fields, WAN fields, Sha256Hex).
CASES = [
    ("valid", lambda a: None),
    ("schedule_null", _set(("cfg", "faults", "schedule"), None)),
    ("missing_required", _delete("decision_log_sha256")),
    ("wrong_type", _set(("cfg", "seed"), "seven")),
    ("bool_is_not_int", _set(("cfg", "n_nodes"), True)),
    ("negative_rate", _set(("cfg", "faults", "drop_rate"), -3)),
    ("nested_episode_kind", _set(EP + (1, "kind"), "meteor")),
    ("workload_element", _set(("workload", 1), [200, "two-oh-one"])),
    ("unknown_key_closed_struct", _rename_nodes),
    ("unknown_key_faults", _set(("cfg", "faults", "drop_rte"), 5)),
    ("extra_checks_open", _set(("extra_checks", "some_future_check"), {"x": 1})),
    ("bad_sha256", _set(("decision_log_sha256",), "nothex")),
    ("wrong_format", _set(("format",), "tpu-paxos-repro-99")),
    ("missing_format", _delete("format")),
    ("proposer_range", _set(("cfg", "proposers"), [0, 5])),
    ("workload_arity", _set(("workload",), [[1]])),
    ("gates_arity", _set(("gates",), [[-1, -1]])),
    ("negative_rounds", _set(("rounds",), -1)),
    ("null_protocol_field", _set(("cfg", "protocol", "prepare_delay_max"), None)),
    ("negative_t0", _set(EP + (0, "t0"), -4)),
    ("engine_unknown", _set(("engine",), "warp")),
    ("engine_serve_without_block", _set(("engine",), "serve")),
    ("devices_zero", _set(("devices",), 0)),
    ("edges_bad_cell", _set(("cfg", "faults", "edges"), {
        "drop_rate": [[0, "x"]], "dup_rate": [[0]], "min_delay": [[0]], "max_delay": [[0]],
    })),
    ("delivery_cut_not_bool", _set(("cfg", "faults", "delivery_cut"), 1)),
    ("not_an_object", None),
]


def _outcome(mod, art):
    try:
        mod.validate_artifact(art)
    except mod.ArtifactSchemaError as e:
        return (e.field, e.problem, str(e))
    return None


@pytest.mark.parametrize("name,mutate", CASES, ids=[c[0] for c in CASES])
def test_validate_artifact_equals_jax(name, mutate):
    """The same verdict, field path and message as the JAX validator,
    and the artifact left as it was (validation never mutates)."""
    if mutate is None:
        art = ["not", "an", "object"]
    else:
        art = valid_artifact()
        mutate(art)
    before = copy.deepcopy(art)
    want = _outcome(jschema, art)
    assert _outcome(tschema, art) == want
    assert art == before
    if name in ("valid", "schedule_null", "extra_checks_open"):
        assert want is None


def test_schema_constants_equal_jax():
    assert tschema.ARTIFACT_FORMAT == jschema.ARTIFACT_FORMAT == tshr.ARTIFACT_FORMAT
    assert set(tschema.ARTIFACT_SCHEMA.props) == set(jschema.ARTIFACT_SCHEMA.props)
    assert tschema.EPISODE_KINDS == jschema.EPISODE_KINDS


@pytest.mark.parametrize("items,lanes", [(list(range(11)), 8), (list(range(8)), 8),
                                         (["a"], 3), ([], 4)])
def test_chunk_pad_equals_jax(items, lanes):
    from tpu_paxos.analysis import chunking as jchunk

    assert tchunk.chunk_pad(items, lanes) == jchunk.chunk_pad(items, lanes)


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _semantic(art):
    art["cfg"]["faults"]["schedule"]["episodes"][0]["t0"] = 4
    art["cfg"]["faults"]["schedule"]["episodes"][0]["t1"] = 4


LOAD_CASES = [
    ("corrupt_field", lambda: json.dumps(dict(valid_artifact(), rounds=-1))),
    ("truncated", lambda: json.dumps(valid_artifact())[:57]),
    ("semantic_constraint", lambda: json.dumps(_mutated(_semantic))),
    ("wrong_format", lambda: json.dumps(dict(valid_artifact(), format="tpu-paxos-repro-0"))),
    ("other_format_only", lambda: json.dumps({"format": "something-else"})),
    ("unreadable", None),
]


def _mutated(fn):
    art = valid_artifact()
    fn(art)
    return art


def _load_outcome(mod_shr, mod_schema, path):
    try:
        case, art = mod_shr.load_artifact(path)
    except mod_schema.ArtifactSchemaError as e:
        return ("error", e.field, e.problem)
    return ("ok", repr(case.cfg), art)


@pytest.mark.parametrize("name,text", LOAD_CASES, ids=[c[0] for c in LOAD_CASES])
def test_load_artifact_errors_equal_jax(name, text, tmp_path):
    """Every rejection of the load path (schema, truncated JSON, missing
    file, a config constructor's refusal) is an ArtifactSchemaError with
    the same field and message (path included) in both packages."""
    path = (str(tmp_path / "missing.json") if text is None
            else _write(tmp_path, f"{name}.json", text()))
    want = _load_outcome(jshr, jschema, path)
    assert want[0] == "error"
    assert _load_outcome(tshr, tschema, path) == want


def test_load_artifact_accepts_valid_as_jax(tmp_path):
    path = _write(tmp_path, "ok.json", json.dumps(valid_artifact()))
    jcase, jart = jshr.load_artifact(path)
    tcase, tart = tshr.load_artifact(path)
    assert tart == jart
    assert tshr._cfg_to_dict(tcase.cfg) == jshr._cfg_to_dict(jcase.cfg)
    assert [w.tolist() for w in tcase.workload] == [w.tolist() for w in jcase.workload]
    assert (tcase.gates, tcase.engine, tcase.devices) == (None, "sim", 1)
    assert tcase.extra_checks == jcase.extra_checks


def test_repro_cli_schema_error_equals_jax(tmp_path, monkeypatch, capsys):
    """``repro <bad>`` exits 2 in both CLIs with the same JSON summary
    naming the field."""
    from tpu_paxos import __main__ as jcli
    from tpu_paxos_torch import __main__ as tcli

    monkeypatch.setenv("TPU_PAXOS_DETERMINISTIC", "0")
    art = valid_artifact()
    art["cfg"]["faults"]["schedule"]["episodes"][0]["node"] = [1]
    path = _write(tmp_path, "bad.json", json.dumps(art))
    assert jcli.run_repro([path, "--json"]) == 2
    want = capsys.readouterr().out
    assert tcli.main(["repro", path, "--json", "--device", "cpu"]) == 2
    got = capsys.readouterr().out
    assert got == want
    summary = json.loads(got)
    assert summary["schema_error"]["field"] == "cfg.faults.schedule.episodes[0].node"
