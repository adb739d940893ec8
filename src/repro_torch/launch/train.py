"""Training launcher (the counterpart of ``repro/launch/train.py``): real
steps of AdamW on ``SyntheticLM`` batches, the reduced configuration by
default (``--full`` for the published one), on the card unless the caller
asks for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --device cpu

The run configuration is the reference's, ``RunConfig(remat="none",
moe_impl="dense", param_dtype="float32")`` with bf16 compute: the models'
plain paths, by configuration (``use_kernels`` stays off, as the
reference's ``use_pallas``), since no kernel has a backward. Parameters
are drawn from a ``torch.Generator`` seeded with ``seed`` on the device
(``jax.random`` draws other numbers from one seed). Full-width Qwen2.5-3B
(3.40 B parameters) takes 54.4 GB for its float32 parameters, grads, m
and v: one H100 holds it at ``remat="none"``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.configs.runtime import RunConfig
from repro_torch.models.transformer import ApplyCtx, init_model_params
from repro_torch.training import AdamWConfig, SyntheticLM, make_train_step, multimodal_extras
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.adamw import init as adamw_init


def run_config(remat: str = "none", compute_dtype: str = "bfloat16") -> RunConfig:
    """The launcher's run configuration (module note)."""
    return RunConfig(remat=remat, moe_impl="dense", param_dtype="float32",
                     compute_dtype=compute_dtype)


def train(
    arch: str,
    steps: int = 20,
    batch: int = 8,
    seq: int = 128,
    reduced: bool = True,
    lr: float = 3e-4,
    seed: int = 0,
    ckpt_dir: str | None = None,
    ckpt_every: int = 0,
    log_every: int = 5,
    *,
    device="cuda",
    remat: str = "none",
):
    """Train ``arch`` for ``steps`` steps. Returns (params, losses, history):
    ``history`` holds each step's metrics as floats (``loss``, ``xent``,
    ``moe_aux``, ``grad_norm``, ``lr``) and its wall ``seconds``, up to the
    host's read of the loss, which waits for the step."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    rcfg = run_config(remat)
    ctx = ApplyCtx(cfg, rcfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_model_params(cfg, rcfg, gen, device)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
    opt_state = adamw_init(params)
    step_fn = make_train_step(ctx, opt_cfg)

    data = SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    extras = {k: torch.from_numpy(v).to(device)
              for k, v in multimodal_extras(cfg, batch, seed).items()}
    losses, history = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        b = {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}
        b.update(extras)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        rec = {k: float(v) for k, v in metrics.items()}
        rec["seconds"] = time.perf_counter() - ts
        losses.append(rec["loss"])
        history.append(rec)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:4d}  loss={rec['loss']:.4f}  xent={rec['xent']:.4f}"
                  f"  gnorm={rec['grad_norm']:.3f}  lr={rec['lr']:.2e}", flush=True)
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, params, opt_state, step=i + 1, meta={"arch": arch})
    wall = time.perf_counter() - t0
    print(f"{steps} steps in {wall:.1f}s  ({steps * batch * seq / wall:.0f} tok/s)")
    if ckpt_dir:
        ckpt.save(ckpt_dir, params, opt_state, step=steps, meta={"arch": arch})
    return params, losses, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    _, losses, _ = train(
        args.arch, args.steps, args.batch, args.seq, args.reduced, args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, device=args.device,
    )
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    print(f"loss {first:.3f} -> {last:.3f} ({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
