"""``python -m horovod_tpu_torch.serving`` — standalone inference server
CLI: train -> export -> serve, as the JAX package's. Replicas run on the
card; ``--device cpu`` asks for the CPU."""

from __future__ import annotations

import argparse

from .config import ServeConfig
from .server import DEFAULT_BUILDER, serve


def main() -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serving",
        description="Serve an exported checkpoint over HTTP with "
                    "continuous batching, SLO-aware admission, and "
                    "elastic replica autoscaling.")
    ap.add_argument("--checkpoint", default=None,
                    help="path written by checkpoint.export_for_inference "
                         "(required unless --llm, whose TinyLM builder "
                         "derives weights from HOROVOD_SERVE_LLM_SEED)")
    ap.add_argument("--builder", default=None,
                    help="'module:function' turning restored state into "
                         "an apply_fn (default: the built-in MLP builder, "
                         "or the TinyLM params builder with --llm)")
    ap.add_argument("--llm", action="store_true",
                    help="serve the token-level generation plane "
                         "(POST /v1/generate; HOROVOD_SERVE_LLM_* knobs) "
                         "instead of stateless /v1/infer")
    ap.add_argument("--port", type=int, default=None,
                    help="override HOROVOD_SERVE_PORT")
    ap.add_argument("--device", default=None,
                    help="where the replicas run: cuda (default; raises "
                         "without a card), cuda:<k>, or cpu")
    args = ap.parse_args()
    cfg = ServeConfig.from_env(**({"port": args.port}
                                  if args.port is not None else {}))
    if args.llm:
        import time

        from .llm.server import DEFAULT_LM_BUILDER, LLMServer

        server = LLMServer(args.checkpoint or "",
                           args.builder or DEFAULT_LM_BUILDER,
                           config=cfg, device=args.device).start()
        try:
            if not server.wait_ready(cfg.replica_start_timeout_s):
                raise RuntimeError("no llm replica became ready — check "
                                   "the replica logs")
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            server.stop()
        return 0
    if not args.checkpoint:
        ap.error("--checkpoint is required (unless --llm)")
    serve(args.checkpoint, args.builder or DEFAULT_BUILDER, cfg,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
