"""Plugins through package entry points (the port of ``qspec_tpu/plugins.py``).

A package extends the port by declaring an entry point in the group
``qspec_tpu_torch.general_plugins``:

    [project.entry-points."qspec_tpu_torch.general_plugins"]
    my_plugin = "my_pkg.plugin:register"

Each is a callable run once a process, when the first engine is built (or
the registry first resolves a config). The use it serves is registering an
architecture:

    def register():
        from qspec_tpu_torch.models.registry import register_model

        @register_model("MyArchForCausalLM")
        def build(hf: dict) -> ModelConfig: ...

``QSPEC_PLUGINS`` (comma-separated names, ``envs.py``) limits which load;
unset, every plugin found loads.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict

from qspec_tpu_torch import envs

logger = logging.getLogger(__name__)

GROUP = "qspec_tpu_torch.general_plugins"
_plugins_loaded = False


def load_plugins_by_group(group: str) -> Dict[str, Callable]:
    """name -> the loaded callable of each allowed entry point of ``group``;
    one that fails to load is logged and skipped."""
    from importlib.metadata import entry_points

    allowed = envs.QSPEC_PLUGINS
    allowed = None if allowed is None else {n.strip() for n in allowed.split(",") if n.strip()}
    plugins: Dict[str, Callable] = {}
    for ep in entry_points(group=group):
        if allowed is not None and ep.name not in allowed:
            logger.info("plugin %s skipped (QSPEC_PLUGINS)", ep.name)
            continue
        try:
            plugins[ep.name] = ep.load()
        except Exception:
            logger.exception("plugin %s failed to load", ep.name)
            continue
        logger.info("plugin %s loaded from %s", ep.name, ep.value)
    return plugins


def load_general_plugins() -> None:
    """Run every ``qspec_tpu_torch.general_plugins`` entry point, once a
    process; one that raises is logged, and the others still run."""
    global _plugins_loaded
    if _plugins_loaded:
        return
    _plugins_loaded = True
    for name, fn in load_plugins_by_group(GROUP).items():
        try:
            fn()
        except Exception:
            logger.exception("plugin %s raised while registering", name)
