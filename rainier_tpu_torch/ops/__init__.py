"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ops.fused_hmc`` (module) holds ``fused_hmc`` (the kernel's wrapper) and
``fused_hmc_reference`` (its plain version)."""
