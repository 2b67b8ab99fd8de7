"""``tpu_paxos_torch.native`` (the port's copy of the C++ host fast paths)
and ``utils/dump.py``: every case of ``tests/test_native.py`` and
``tests/test_sim.py::test_dump_helpers_format`` mirrored, the native
scans held against the numpy plain versions, and both held against the
JAX package's on the same seeded arrays, exactly.  The library builds
with g++ at first use; a failed build fails these tests, never skips
them."""

import filecmp
import os

import numpy as np
import pytest

from tpu_paxos import native as jnative
from tpu_paxos.utils import dump as jdump
from tpu_paxos_torch import native
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.harness import validate
from tpu_paxos_torch.replay.decision_log import decision_log as render_log
from tpu_paxos_torch.utils import dump

NONE = int(val.NONE)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_builds():
    assert native.available(), "g++ build of tpu_paxos_torch.native failed"
    # the port builds its own library from its own copy of the source
    assert os.path.dirname(native._LIB_PATH).endswith(os.path.join("build", "native_torch"))
    assert native._SRC.startswith(os.path.join(REPO, "tpu_paxos_torch"))


def _random_learned(rng, i=2000, a=5, holes=0.3):
    """Consistent learned array: one chosen value per instance, revealed
    to a random subset of nodes."""
    chosen = rng.choice(4 * i, size=i, replace=False).astype(np.int32)
    chosen[rng.random(i) < 0.1] = NONE
    know = rng.random((i, a)) > holes
    learned = np.where(know & (chosen != NONE)[:, None], chosen[:, None], NONE)
    return learned.astype(np.int32), chosen


def test_agreement_equivalence():
    rng = np.random.default_rng(0)
    learned, _ = _random_learned(rng)
    assert native.check_agreement(learned) is None
    validate.check_agreement(learned)  # numpy path agrees (small size)
    bad = learned.copy()
    row = np.flatnonzero((bad != NONE).sum(axis=1) >= 2)[7]
    cols = np.flatnonzero(bad[row] != NONE)
    bad[row, cols[1]] = bad[row, cols[0]] + 1
    assert native.check_agreement(bad) == row
    with pytest.raises(validate.InvariantViolation, match=f"instance {row}"):
        validate.check_agreement(bad)


def test_chosen_per_instance_equivalence():
    rng = np.random.default_rng(1)
    learned, chosen = _random_learned(rng)
    nat = native.chosen_per_instance(learned)
    py = validate._chosen_per_instance(learned)
    assert np.array_equal(nat, py)
    visible = (learned != NONE).any(axis=1)
    assert np.array_equal(nat[visible], chosen[visible])


def test_check_unique_both_paths():
    chosen = np.asarray([5, NONE, 9, -7, 12], np.int32)  # -7 = noop
    assert native.check_unique(chosen) is None
    assert native.check_unique(chosen, max_vid=100) is None
    dup = np.asarray([5, 9, 5], np.int32)
    assert native.check_unique(dup) == 5
    assert native.check_unique(dup, max_vid=100) == 5
    over = np.asarray([150, 150], np.int32)
    assert native.check_unique(over, max_vid=100) == 150
    assert native.check_unique(np.asarray([150, 99], np.int32), max_vid=100) is None


def _log_inputs(seed=2, i=3000, stride=100_000):
    rng = np.random.default_rng(seed)
    cv = np.full(i, NONE, np.int32)
    cb = np.full(i, NONE, np.int32)
    decided = rng.random(i) < 0.8
    cv[decided] = (
        rng.integers(0, 4, size=decided.sum()) * stride
        + rng.integers(0, 1000, size=decided.sum())
    ).astype(np.int32)
    noop = decided & (rng.random(i) < 0.2)
    cv[noop] = val.NOOP_BASE - rng.integers(0, 4 * i, size=noop.sum()).astype(np.int32)
    cb[decided] = rng.integers(1, 1 << 20, size=decided.sum()).astype(np.int32)
    return cv, cb, stride, i


def test_decision_log_equivalence():
    """The native renderer's output is byte-identical to the port's numpy
    renderer's for real and no-op vids."""
    cv, cb, stride, i = _log_inputs()
    py = render_log(cv, cb, stride=stride, n_instances=i)
    nat = native.render_decision_log(cv, cb, stride=stride, n_instances=i)
    assert nat == py


def test_validate_routes_large_arrays_through_native(monkeypatch):
    """At ``1 << 16`` cells and above the checks take the C++ path and
    still report violations through the same exception."""
    rng = np.random.default_rng(3)
    learned, _ = _random_learned(rng, i=40_000, a=5)
    assert learned.size >= validate._NATIVE_MIN_CELLS
    calls = []
    real = native.check_agreement
    monkeypatch.setattr(native, "check_agreement", lambda x: calls.append(x) or real(x))
    validate.check_agreement(learned)
    validate.check_exactly_once(learned)
    assert len(calls) == 1
    bad = learned.copy()
    row = np.flatnonzero((bad != NONE).sum(axis=1) >= 2)[0]
    cols = np.flatnonzero(bad[row] != NONE)
    bad[row, cols[1]] += 1
    with pytest.raises(validate.InvariantViolation, match="agreement"):
        validate.check_agreement(bad)


def test_native_scale_smoke():
    """1M-instance validation + render completes on the native path."""
    i, a = 1 << 20, 5
    chosen = np.arange(i, dtype=np.int32)
    learned = np.broadcast_to(chosen[:, None], (i, a)).copy()
    assert native.check_agreement(learned) is None
    assert native.check_unique(chosen, max_vid=i) is None
    out = native.render_decision_log(
        chosen[: 1 << 16], chosen[: 1 << 16] % 7, stride=1 << 30, n_instances=i
    )
    assert out.count("\n") == 1 << 16


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    """Unlike the JAX package, nothing falls back: a source g++ rejects
    raises NativeBuildError carrying g++'s message."""
    src = tmp_path / "validate.cpp"
    src.write_text("this is not c++\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "build" / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="error"):
        native.load()


# ---------------- the port against the JAX package ----------------

def test_source_is_the_jax_packages():
    """The port keeps its own copy of validate.cpp; below its header
    comment it is the JAX package's byte for byte."""
    def body(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("#include"):]

    assert body(native._SRC) == body(jnative._SRC)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_equals_the_jax_native_exactly(seed):
    assert jnative.available()
    rng = np.random.default_rng(seed)
    learned, chosen = _random_learned(rng)
    bad = learned.copy()
    row = np.flatnonzero((bad != NONE).sum(axis=1) >= 2)[seed]
    cols = np.flatnonzero(bad[row] != NONE)
    bad[row, cols[1]] = bad[row, cols[0]] + 1
    for arr in (learned, bad):
        assert native.check_agreement(arr) == jnative.check_agreement(arr)
        assert np.array_equal(native.chosen_per_instance(arr), jnative.chosen_per_instance(arr))
    dup = chosen.copy()
    dup[-1] = dup[0] if dup[0] != NONE else dup[1]
    for arr, bound in ((chosen, -1), (dup, -1), (dup, 4 * len(chosen)), (dup, 3)):
        assert native.check_unique(arr, max_vid=bound) == jnative.check_unique(arr, max_vid=bound)
    cv, cb, stride, i = _log_inputs(seed)
    assert (native.render_decision_log(cv, cb, stride, i)
            == jnative.render_decision_log(cv, cb, stride, i))


def test_dump_helpers_format():
    assert dump.dump_hex(b"\x00\xff\x10") == "00 FF 10"
    assert dump.dump_hex(bytes(300)).endswith("(+44 bytes)")
    s = dump.dump_array("chosen", np.asarray([[5, -1], [7, 8]], np.int32), 3)
    assert s == "chosen[2, 2]:int32= 5 . 7 .. (+1)"


def test_dump_equals_the_jax_dump_exactly():
    rng = np.random.default_rng(4)
    buf = rng.integers(0, 256, size=400, dtype=np.uint8).tobytes()
    for limit in (0, 16, 256, 1000):
        assert dump.dump_hex(buf, limit) == jdump.dump_hex(buf, limit)
    arr = rng.integers(-1, 9, size=(6, 7)).astype(np.int32)
    for limit in (0, 5, 32, 100):
        assert dump.dump_array("x", arr, limit) == jdump.dump_array("x", arr, limit)
    # the module is the JAX package's byte for byte
    assert filecmp.cmp(dump.__file__, jdump.__file__, shallow=False)
