"""The flight recorder and its renderers (port of ``tpu_paxos/telemetry``).

``recorder`` holds the accumulators the general engine carries through
its round loop when built with ``telemetry=True`` (one set per lane),
their on-device reductions and the host-side dict renderers;
``diagnose`` is the deterministic breach-attribution classifier over the
windowed series; ``export`` renders a run as a Chrome-trace/Perfetto
timeline (``python -m tpu_paxos_torch trace``).

Submodules load on first attribute access (PEP 562), as in the JAX
package.
"""

_SUBMODULES = ("recorder", "export", "diagnose")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"tpu_paxos_torch.telemetry.{name}")
    raise AttributeError(
        f"module 'tpu_paxos_torch.telemetry' has no attribute {name!r}"
    )
