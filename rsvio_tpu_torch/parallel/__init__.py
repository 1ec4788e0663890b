"""Landmark-sharded window solvers and steps on torch.distributed."""
