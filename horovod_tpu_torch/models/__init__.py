"""Models of horovod_tpu_torch."""
from .transformer import TransformerLM

__all__ = ["TransformerLM"]
