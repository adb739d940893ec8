# Hand-written Hopper kernels for the hot spots that the JAX package wrote
# in Pallas for the TPU, each beside its plain PyTorch version (ref.py):
#   flash_attention — causal/SWA/GQA online-softmax attention (prefill)
# Built and dispatched by repro_torch.kernels.runtime. The dcov and SSD
# scan kernels are still to port (ROADMAP queue 2).
