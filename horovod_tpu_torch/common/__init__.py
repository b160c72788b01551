"""Lifecycle, topology and configuration of horovod_tpu_torch."""
