"""Open-loop serving on the port: consensus as a traffic-serving service
(port of ``tpu_paxos/serve/``).

Values *arrive* on the virtual clock (Poisson, heavy-tailed, bursty,
diurnal or replayed from a trace), are admitted into the general
engine's queue ring between fixed dispatch windows, and the metric is
ingest-to-commit latency (p50/p99/p999) at an offered load, with a
windowed SLO burn-rate monitor.

Submodules load on first attribute access (PEP 562), as in the JAX
package: ``arrivals`` the arrival processes and the admission plan
(numpy only), ``driver`` the dispatch window over the engine's round,
``harness`` the host loop, the load sweep and the ``serve`` CLI, and
``fleet`` the multi-tenant serve lanes with on-device per-lane SLO
verdicts (``serve --fleet``), and ``control`` the cause-aware admission
controller (``serve --control``, ``--control-ab``, ``serve --fleet
--control``) with its repro artifacts, and ``breach`` the serve axis of
the selection loop (offered-load genomes under weather presets, scored
by windowed SLO burn; ``fleet/evolve``).
"""

_SUBMODULES = ("arrivals", "breach", "control", "driver", "fleet", "harness")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"tpu_paxos_torch.serve.{name}")
    raise AttributeError(f"module 'tpu_paxos_torch.serve' has no attribute {name!r}")
