"""Environment-variable knobs (the port of ``qspec_tpu/envs.py``).

Each knob has one typed accessor here, read when accessed
(``qspec_tpu_torch.envs.QSPEC_PLUGINS``), so a test may set the variable
after import. Only the knobs the port reads are kept: ``QSPEC_PLUGINS``
(``plugins.py``) and ``QSPEC_RING_DRAFT`` (``engine/model_runner.py``).
Left out: ``QSPEC_CACHE_DIR`` (the XLA compile cache, which the port does
not have), ``QSPEC_TPU_TESTS`` (the JAX package's TPU test tier), and the
serving and engine defaults (``QSPEC_HOST``, ``QSPEC_PORT``,
``QSPEC_API_KEY``, ``QSPEC_KV_CACHE_DTYPE``, ``QSPEC_GPU_MEMORY_UTILIZATION``,
``QSPEC_ENABLE_PREFIX_CACHING``, ``QSPEC_OTLP_ENDPOINT``,
``QSPEC_LOG_STATS_INTERVAL``), which no code of the JAX package reads
either: the command-line flags set those.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional


def _bool(name: str, default: bool) -> Callable[[], bool]:
    return lambda: os.environ.get(name, "1" if default else "0").lower() in (
        "1", "true", "yes", "on")


def _str(name: str, default: Optional[str]) -> Callable[[], Optional[str]]:
    return lambda: os.environ.get(name, default)


# name -> thunk, evaluated on attribute access
environment_variables: Dict[str, Callable[[], Any]] = {
    # comma-separated allowlist of plugin names; unset loads every plugin
    "QSPEC_PLUGINS": _str("QSPEC_PLUGINS", None),
    # "0" gives the windowed draft a full KV pool instead of its ring pool
    "QSPEC_RING_DRAFT": _bool("QSPEC_RING_DRAFT", True),
}


def __getattr__(name: str) -> Any:
    if name in environment_variables:
        return environment_variables[name]()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return list(environment_variables)
