"""Token-level LLM serving plane: the port's counterpart of
``horovod_tpu.serving.llm``. The model (TinyLM, or a builder's own) and
the paged KV pool live on each replica's card; the router holds only host
state.

The request-level plane batches *stateless* forward passes: a request is
one padded device dispatch. Autoregressive generation breaks that model —
a request is a *sequence* that occupies device state (its KV cache) for
hundreds of iterations, and different sequences finish at wildly
different times. This package replaces request-level dispatch with the
two ideas that define modern LLM serving:

- **iteration-level scheduling** (Orca — Yu et al., OSDI '22): the engine
  step is ONE decode iteration over the active batch; queued prefills are
  admitted into free slots mid-stream and finished sequences retire the
  moment they emit EOS or hit ``max_tokens``, so a short request never
  waits behind a long one (``scheduler.py``);
- **paged KV memory** (vLLM / PagedAttention — Kwon et al., SOSP '23):
  the KV cache is fixed-size blocks handed out from a free list, with a
  per-sequence block table mapping token positions to blocks. Memory —
  not batch shape — bounds concurrency; exhaustion preempts-and-requeues
  the newest sequence instead of OOMing (``kv_cache.py``).

On top, replicas split into **prefill and decode pools** with explicit KV
handoff over the authenticated ``BasicService`` channel (``handoff.py``,
``manager.py``) — the disaggregation that stops long prefills from
stalling every in-flight decode — and admission control switches its
currency from queue depth to *projected KV-block availability*
(``admission.KVAdmission``).

Entry points::

    from horovod_tpu_torch.serving.llm import LLMServer
    server = LLMServer().start()          # knobs: HOROVOD_SERVE_LLM_*
    # POST /v1/generate {"prompt": [3, 17, 5], "max_tokens": 32}
"""

from .kv_cache import BlockAllocator, PagedKVCache, blocks_for  # noqa: F401
from .scheduler import (  # noqa: F401
    IterationScheduler,
    Sequence,
)
from .generator import DecodeEngine, GenQueue, GenRequest  # noqa: F401
from .handoff import pack_kv, unpack_kv  # noqa: F401
from .manager import PoolManager  # noqa: F401
from .server import DEFAULT_LM_BUILDER, LLMServer  # noqa: F401
