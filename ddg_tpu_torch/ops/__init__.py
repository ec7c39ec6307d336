"""Math substrate (noise schedules, forward process, sampling primitives)
and the Hopper kernels with their plain PyTorch versions."""
