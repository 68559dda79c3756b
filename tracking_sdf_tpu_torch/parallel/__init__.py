"""Multi-device runs: the grid in i-slabs over a torch.distributed process
group, one rank per device (counterpart of tracking_sdf_tpu.parallel)."""
