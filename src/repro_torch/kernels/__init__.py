# Hand-written Hopper kernels for the hot spots that the JAX package wrote
# in Pallas for the TPU, each beside its plain PyTorch version (ref.py):
#   flash_attention — causal/SWA/GQA online-softmax attention (prefill)
#   ssd_scan        — the Mamba2 SSD chunked scan (Mamba2 prefill)
#   dcov            — the distance-covariance Gram (the CORAL loop's dCor)
#   ssm_decode      — Mamba2's decode state step (no Pallas counterpart)
#   selective_scan  — the Mamba-1 scan of the published Hymba (no Pallas counterpart)
# Built and dispatched by repro_torch.kernels.runtime.
