"""The one module of the benchmark that reaches into the system under test,
``repro_torch``: the model configuration it runs, its parameter layout,
its serving engine and runtime.

The configuration file (``configs/<name>.json``) holds the configuration
as it is run, under the published model's key names; :func:`model_config`
turns it into the program's ``ModelConfig`` by starting from the
program's registry entry of that name and setting every key the file
holds (the family file's mapping), so the file, and not the registry, is
what runs.
"""
from __future__ import annotations

from perfbench import manifest


def model_config(conf: dict):
    """The program's ``ModelConfig`` for configuration file ``conf``: the
    registry's entry, set from the file by its family's file
    (``perfbench/families/<family>.py``)."""
    from repro_torch.configs.registry import get_config

    return manifest.family_of(conf).model_config(conf, get_config(conf["registry"]))


def param_shapes(cfg) -> dict:
    """The program's parameter tree as nested dicts of shapes."""
    from repro_torch.models.layers import ParamSpec, tree_map_specs
    from repro_torch.models.transformer import param_specs

    def shape(s: ParamSpec):
        return tuple(s.shape)

    return tree_map_specs(shape, param_specs(cfg))


def build_engine(conf: dict, params: dict, batch: int, max_len: int, device):
    """A ``ServingEngine`` over ``params`` in the configuration's dtype, the
    hand-written kernels on, decode replayed from CUDA graphs on the card."""
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models.transformer import ApplyCtx
    from repro_torch.serving.engine import ServingEngine

    cfg = model_config(conf)
    rcfg = RunConfig(param_dtype=conf["dtype"], compute_dtype=conf["dtype"], use_kernels=True)
    return ServingEngine(ApplyCtx(cfg, rcfg), params, batch, max_len)


def runtime(engine, batch: int, concurrency: int):
    from repro_torch.serving.runtime import ServingRuntime

    return ServingRuntime(engine, batch_size=batch, concurrency=concurrency)


def request(rid: int, prompt, max_new_tokens: int, arrival_s, tokens):
    from repro_torch.serving.runtime import Request

    return Request(rid, prompt, int(max_new_tokens), arrival_s=arrival_s, tokens=tokens)
