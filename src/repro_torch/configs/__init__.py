from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, SSMConfig  # noqa: F401


def __getattr__(name):  # lazy: avoid import cycle with registry's arch imports
    if name in ("REGISTRY", "ARCH_IDS", "get_config"):
        from repro_torch.configs import registry

        return getattr(registry, name)
    raise AttributeError(name)
