"""The library surface's profiler hook on a card: a trace of the general
engine holds one CUDA kernel event per launch the wrappers count, the
fast path's window kernel one per window, ``--trace-dir`` leaves the
CLI's stdout unchanged, and a CUDA trace without a kernel event raises.

These tests need a CUDA card and skip without one.  The file imports
neither ``jax`` nor ``tpu_paxos``, so run it there without the suite's
conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_library_cuda.py
"""

import contextlib
import io
import os

import pytest
import torch

from tpu_paxos_torch import __main__ as tcli
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch.core import fast
from tpu_paxos_torch.core import fastwin as tfw
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.core import simkern as tsk
from tpu_paxos_torch.utils import log as tlog

pytestmark = pytest.mark.cuda

DEBUG_ARGS = ["4", "4", "10", "--seed=0", "--net-drop-rate=500", "--net-dup-rate=1000",
              "--net-max-delay=2"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler's kernel events come from the card")
    tsk.load()
    tfw.load()


def test_trace_kernel_events_equal_the_launch_counters(card, tmp_path):
    cfg = tcfg.SimConfig(n_nodes=5, n_instances=1 << 16, proposers=(0, 1), seed=0,
                         assign_window=1 << 13,
                         faults=tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2))
    tsk.reset_counts()
    with tlog.profile_trace(str(tmp_path), "cuda"):
        res = tsim.run(cfg, device="cuda")
    assert res.done
    path = str(tmp_path / tlog.TRACE_FILE)
    launches = dict(tsk.LAUNCHES)
    assert min(launches.values()) > 0
    events = tlog.trace_kernel_counts(path, [f"{k}_kernel" for k in launches])
    assert {k: events[f"{k}_kernel"] for k in launches} == launches
    st = fast.init_state(tfw.TILE, 3, device="cuda")
    tfw.reset_counts()
    with tlog.profile_trace(str(tmp_path / "fw"), "cuda"):
        tfw.steady_state_windows_fused(st, None, reps=3, quorum=2, iota_vids=True)
    fw_events = tlog.trace_kernel_counts(str(tmp_path / "fw" / tlog.TRACE_FILE), ["window_kernel"])
    assert fw_events["window_kernel"] == 3 == tfw.LAUNCHES["steady_state_windows"]


def test_trace_dir_leaves_the_cli_stdout_unchanged(card, tmp_path):
    outs = []
    for extra in ([], ["--trace-dir", str(tmp_path)]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tcli.main(DEBUG_ARGS + ["--device", "cuda"] + extra) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert tlog.trace_kernel_counts(str(tmp_path / tlog.TRACE_FILE),
                                    ["accum_acks_kernel"])["accum_acks_kernel"] > 0


def test_a_cuda_trace_without_a_kernel_event_raises(card, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA kernel event"):
        with tlog.profile_trace(str(tmp_path), "cuda"):
            pass
    assert os.path.exists(tmp_path / tlog.TRACE_FILE)
