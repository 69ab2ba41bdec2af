"""Data parallelism of the port over processes (`torch.distributed`)."""
