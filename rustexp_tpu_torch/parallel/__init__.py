"""Multi-process rendering on torch.distributed (rustexp_tpu/parallel)."""
