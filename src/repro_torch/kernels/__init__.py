# Hand-written Hopper kernels for the hot spots that the JAX package wrote
# in Pallas for the TPU, each beside its plain PyTorch version (ref.py):
#   flash_attention — causal/SWA/GQA online-softmax attention (prefill)
#   ssd_scan        — the Mamba2 SSD chunked scan (Mamba2 prefill)
# Built and dispatched by repro_torch.kernels.runtime. The dcov kernel is
# still to port (ROADMAP queue 2).
