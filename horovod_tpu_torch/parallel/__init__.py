"""Collectives and tensor fusion over torch.distributed."""
