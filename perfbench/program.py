"""The one module of the benchmark that reaches into the system under test,
``repro_torch``: the model configuration it runs, its parameter layout,
its serving engine and runtime.

The configuration file (``configs/<name>.json``) holds the configuration
as it is run, under the published model's key names; :func:`model_config`
turns it into the program's ``ModelConfig`` by starting from the
program's registry entry of that name and setting every key the file
holds, so the file, and not the registry, is what runs.
"""
from __future__ import annotations

import dataclasses

# published key -> the program's ModelConfig field, per family
_QWEN2_KEYS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "attention_bias": "qkv_bias",
}
_MAMBA2_KEYS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "vocab_size": "vocab",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
}
_MAMBA2_SSM_KEYS = {
    "state_size": "d_state",
    "head_dim": "headdim",
    "expand": "expand",
    "chunk_size": "chunk_size",
    "conv_kernel": "d_conv",
}


def model_config(conf: dict):
    """The program's ``ModelConfig`` for configuration file ``conf``."""
    from repro_torch.configs.registry import get_config

    base = get_config(conf["registry"])
    family = conf["family"]
    if family == "qwen2":
        if conf.get("hidden_act", "silu") != "silu":
            raise ValueError("the qwen2 family runs SwiGLU")
        return dataclasses.replace(base, **{f: conf[k] for k, f in _QWEN2_KEYS.items()})
    if family == "mamba2":
        if conf.get("n_groups", 1) != 1:
            raise ValueError("the program's Mamba2 shares B and C over all heads (n_groups 1)")
        ssm = dataclasses.replace(base.ssm, **{f: conf[k] for k, f in _MAMBA2_SSM_KEYS.items()})
        if ssm.n_ssm_heads(conf["hidden_size"]) != conf["num_heads"]:
            raise ValueError("num_heads disagrees with expand * hidden_size / head_dim")
        return dataclasses.replace(base, ssm=ssm,
                                   **{f: conf[k] for k, f in _MAMBA2_KEYS.items()})
    raise ValueError(f"no program mapping for family {family!r}")


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
