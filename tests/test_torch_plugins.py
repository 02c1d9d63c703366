"""The port's plugins and environment knobs (``tests/test_plugins.py``'s
four cases against the port's ``envs``, ``plugins`` and registry)."""

import pytest


def test_env_registry(monkeypatch):
    from qspec_tpu_torch import envs

    monkeypatch.delenv("QSPEC_PLUGINS", raising=False)
    monkeypatch.delenv("QSPEC_RING_DRAFT", raising=False)
    assert envs.QSPEC_PLUGINS is None and envs.QSPEC_RING_DRAFT is True
    monkeypatch.setenv("QSPEC_PLUGINS", "a,b")
    assert envs.QSPEC_PLUGINS == "a,b"
    monkeypatch.setenv("QSPEC_RING_DRAFT", "0")
    assert envs.QSPEC_RING_DRAFT is False
    with pytest.raises(AttributeError):
        envs.QSPEC_TPU_TESTS           # the JAX package's TPU tier: left out
    assert set(dir(envs)) == {"QSPEC_PLUGINS", "QSPEC_RING_DRAFT"}


def _fake_eps(monkeypatch, eps):
    import importlib.metadata as md

    class EP:
        def __init__(self, name, fn):
            self.name, self._fn, self.value = name, fn, f"fake:{name}"

        def load(self):
            return self._fn

    real = md.entry_points

    def fake(group=None, **kw):
        if group == "qspec_tpu_torch.general_plugins":
            return [EP(n, f) for n, f in eps.items()]
        return real(group=group, **kw) if group else real(**kw)

    monkeypatch.setattr(md, "entry_points", fake)


def test_plugin_loading_and_allowlist(monkeypatch):
    from qspec_tpu_torch import plugins

    monkeypatch.delenv("QSPEC_PLUGINS", raising=False)
    _fake_eps(monkeypatch, {"good": lambda: None, "other": lambda: None})
    assert set(plugins.load_plugins_by_group(plugins.GROUP)) == {"good", "other"}
    monkeypatch.setenv("QSPEC_PLUGINS", "good")
    assert set(plugins.load_plugins_by_group(plugins.GROUP)) == {"good"}


def test_plugin_registers_model_arch(monkeypatch):
    """A plugin's architecture resolves through the registry (and so
    through a checkpoint directory's config.json) and serves."""
    from qspec_tpu_torch import LLMEngine, plugins
    from qspec_tpu_torch.config import EngineConfig, ModelConfig
    from qspec_tpu_torch.models import registry
    from qspec_tpu_torch.models.llama import init_params

    def register():
        @registry.register_model("TestPluginForCausalLM")
        def _build(hf):
            return ModelConfig.tiny(num_layers=hf["num_hidden_layers"])

    monkeypatch.delenv("QSPEC_PLUGINS", raising=False)
    _fake_eps(monkeypatch, {"archplug": register})
    monkeypatch.setattr(plugins, "_plugins_loaded", False)
    monkeypatch.setattr(registry, "_REGISTRY", {})
    plugins.load_general_plugins()
    assert "TestPluginForCausalLM" in registry.supported_architectures()
    cfg = registry.resolve({"architectures": ["TestPluginForCausalLM"],
                            "num_hidden_layers": 1})
    assert cfg.num_layers == 1
    eng = LLMEngine(EngineConfig(model=cfg), init_params(cfg, device="cpu"), num_pages=8,
                    device="cpu")
    eng.add_request([1, 2, 3])
    while eng.has_unfinished_requests():
        eng.step()


def test_plugin_load_idempotent_and_a_failing_one_is_logged(monkeypatch, caplog):
    from qspec_tpu_torch import plugins

    calls = []

    def bad():
        raise RuntimeError("boom")
    monkeypatch.delenv("QSPEC_PLUGINS", raising=False)
    _fake_eps(monkeypatch, {"once": lambda: calls.append(1), "bad": bad})
    monkeypatch.setattr(plugins, "_plugins_loaded", False)
    plugins.load_general_plugins()
    plugins.load_general_plugins()
    assert calls == [1]
    assert "plugin bad raised" in caplog.text
