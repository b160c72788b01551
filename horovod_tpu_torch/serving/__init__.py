"""hvd.serving — the online-inference vertical: the port's counterpart of
``horovod_tpu.serving``, with the same public API, HTTP routes, replica
protocol, env contract and metric names.

Continuous-batching serving for exported checkpoints, composed from the
training stack's parts: the metrics HTTP-server pattern as the frontend,
K model steps per dispatch (one CUDA graph per bucket shape on the card),
the elastic driver's slot-pool/supervision shape as the replica manager,
and the elastic fault hooks for chaos testing. Two planes: the
request-level ``InferenceServer`` (``POST /v1/infer``) and the token-level
``llm.LLMServer`` (``POST /v1/generate``). Replicas run on the card unless
the caller passes ``device="cpu"``; the router never touches a device.

    from horovod_tpu_torch import serving
    server = serving.InferenceServer(checkpoint="/ckpts/serve").start()

or standalone::

    python -m horovod_tpu_torch.serving --checkpoint /ckpts/serve \
        --builder my_project.serving:build

Knobs: HOROVOD_SERVE_PORT / _MAX_BATCH / _MAX_WAIT_MS / _SLO_MS and
friends — see :class:`~.config.ServeConfig`.
"""

from .admission import AdmissionController  # noqa: F401
from .batcher import (  # noqa: F401
    ContinuousBatcher,
    Request,
    bucket_for,
    bucket_sizes,
    pad_batch,
)
from .config import ServeConfig  # noqa: F401
from .manager import ReplicaManager, autoscale_decision  # noqa: F401
from .model import (  # noqa: F401
    load_for_serving,
    make_decode_fn,
    mlp_builder,
    resolve_builder,
)
from .server import DEFAULT_BUILDER, InferenceServer, serve  # noqa: F401
from . import llm  # noqa: F401  (token-level plane: serving.llm.LLMServer)
