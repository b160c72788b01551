"""LLM replica worker process — one prefill, decode, or both-role engine
behind the router.

Spawned by :class:`~.manager.PoolManager` as ``python -m
horovod_tpu_torch.serving.llm.replica`` with the request-level plane's
replica envelope (HVD_SERVE_REPLICA_ID / _SECRET / _READY_FILE /
_CHECKPOINT / _BUILDER / _DEVICE) plus ``HVD_SERVE_LLM_ROLE`` and the
serialized :class:`~..config.LLMConfig` env contract. The port's
counterpart of ``horovod_tpu.serving.llm.replica``: where the JAX replica
runs TinyLM in numpy on the host, this one builds the model and the KV
pool on its device, ``HVD_SERVE_DEVICE`` (``cuda:<i>`` from the router,
or ``cpu`` where the caller asked for the CPU). A replica told to use a
card it does not have raises; it never carries on on the CPU. TF32 is
off (``model.exact_float32``), and every thread that runs model code —
the service's handler threads (prefill) and the decode engine's thread —
makes the replica's card its current device first.

Service protocol (authenticated ``BasicService``, one router worker
channel per replica):

- ``prefill``   (roles prefill/both): prompt tokens -> the KV pages and
  the first generated token — the handoff payload;
- ``submit_seq`` (roles decode/both): a prefilled sequence (tokens + KV
  pages) enters the iteration scheduler's waiting queue;
- ``generate``  (role both): a raw prompt enters the scheduler; prefill
  happens inside the decode engine — the colocated fast path;
- ``poll``      (roles decode/both): drain finished sequences, report
  per-sequence progress (the router's TTFT observation for colocated
  mode) and scheduler stats (the router's KV/occupancy telemetry);
- ``ping`` / ``stats``: bring-up and observability.

Chaos rides the elastic fault hooks exactly like the request-level plane:
``HOROVOD_FAULT_INJECT_STEP=N`` kills this replica at its N-th
*model-touching* request (prefill/submit/generate — poll is a clock
tick, counting it would make N meaningless).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback

import torch

from ...elastic import fault
from ...runner.network import BasicService
from ...tracing import flight as _flight
from ...tracing.serve import get_serve_tracer, init_serve_tracer
from ...utils.logging import log
from ..config import LLMConfig
from .generator import DecodeEngine
from .handoff import is_sharded_payload, unpack_kv, unpack_kv_sharded
from .kv_cache import PagedKVCache
from .scheduler import IterationScheduler
from ..model import bind_device


def _host(t: torch.Tensor):
    """A page as contiguous host float32 numpy (it leaves the card)."""
    return t.detach().to("cpu", torch.float32).contiguous().numpy()


def per_chip_persistent_nbytes(llm_cfg: LLMConfig, params,
                               with_cache: bool = True) -> int:
    """Persistent bytes ONE chip of this replica group must hold: its
    parameter slice plus (decode/both roles) its KV page slice. This is
    the figure the HOROVOD_SERVE_LLM_CHIP_BUDGET_BYTES gate compares —
    access-time gathers are transient and do not count, exactly like the
    training plane's ZeRO accounting."""
    from ..model import ShardedLMParams, lm_params_nbytes

    if isinstance(params, ShardedLMParams):
        p = params.per_chip_nbytes()
    else:
        p = lm_params_nbytes(params)
    if not with_cache:
        return p
    d = int(params["dim"]) // llm_cfg.model_shards
    kv = llm_cfg.num_blocks * llm_cfg.block_size * d * 4 * 2  # f32 K+V
    return p + kv


def check_chip_budget(llm_cfg: LLMConfig, params,
                      with_cache: bool = True) -> int:
    """Refuse to start a replica whose per-chip footprint exceeds the
    chip budget — the loud failure that makes the oversized-model smoke
    meaningful (an unsharded replica of the same model must die here)."""
    need = per_chip_persistent_nbytes(llm_cfg, params, with_cache)
    if llm_cfg.chip_budget and need > llm_cfg.chip_budget:
        raise MemoryError(
            f"per-chip persistent footprint {need} B exceeds chip budget "
            f"{llm_cfg.chip_budget} B at model_shards="
            f"{llm_cfg.model_shards}; shard the model across more chips "
            f"(HOROVOD_SERVE_LLM_MODEL_SHARDS) or raise "
            f"HOROVOD_SERVE_LLM_CHIP_BUDGET_BYTES")
    return need


class LLMReplicaService(BasicService):
    def __init__(self, key: bytes, role: str, params: dict, engine,
                 llm_cfg: LLMConfig, replica_id: int,
                 host: str = "127.0.0.1", device=None) -> None:
        self.device = torch.device(device if device is not None else "cpu")
        self.numerics: dict = {}  # set by main() (model.exact_float32)
        self.role = role
        self.params = params
        self.engine = engine          # None on a pure prefill replica
        self.llm = llm_cfg
        self.replica_id = replica_id
        self._requests = 0
        self._prefills = 0
        self.per_chip_bytes = 0   # set by main() after the budget check
        super().__init__(key, host=host, port=0)

    def handle(self, request, client_addr):
        kind = request.get("kind")
        try:
            bind_device(self.device)
            if kind == "ping":
                return {"ok": True, "replica": self.replica_id,
                        "role": self.role}
            if kind == "stats":
                stats = self.engine.stats() if self.engine else {}
                return {"ok": True, "replica": self.replica_id,
                        "role": self.role, "prefills": self._prefills,
                        "model_shards": self.llm.model_shards,
                        "per_chip_bytes": self.per_chip_bytes,
                        "device": str(self.device),
                        "numerics": self.numerics, "stats": stats}
            if kind == "prefill":
                return self._prefill(request)
            if kind == "submit_seq":
                return self._submit_seq(request)
            if kind == "generate":
                return self._generate(request)
            if kind == "poll":
                if self.engine is None:
                    return {"ok": False, "error":
                            f"poll on a {self.role} replica"}
                resp = self.engine.poll()
                resp["ok"] = True
                return resp
            if kind == "clock_align":
                # The router measured this replica's clock offset over
                # the clock_probe exchange and pushes it back; the span
                # recorder re-announces it in its meta line so the
                # collector aligns replica spans to the router clock.
                tracer = get_serve_tracer()
                if tracer is not None:
                    tracer.set_clock_offset(int(request["offset_ns"]))
                return {"ok": True}
            return {"ok": False, "error": f"unknown kind {kind!r}"}
        except Exception:  # noqa: BLE001 - forwarded to the router verbatim
            return {"ok": False, "error": traceback.format_exc(limit=20)}

    def _chaos_tick(self) -> None:
        self._requests += 1
        fault.maybe_die(self._requests)

    def _prefill(self, request):
        if self.role == "decode":
            return {"ok": False, "error": "prefill on a decode replica"}
        self._chaos_tick()
        from ..model import lm_prefill

        tokens = [int(t) for t in request["tokens"]]
        tracer = get_serve_tracer()
        t0 = tracer.now_ns() if tracer else 0
        k, v, nxt = lm_prefill(self.params, tokens)
        self._prefills += 1
        if tracer and request.get("trace"):
            tracer.span(request["trace"], "prefill", t0, tracer.now_ns(),
                        side="replica", n_tokens=len(tokens))
        # The pages leave the card here: the reply holds host numpy only.
        if self.llm.model_shards > 1:
            # Sharded group: the pages leave this replica as
            # per-model-shard dim-slices so the decode group's shards each
            # land their own slice (handoff.pack_kv_sharded downstream).
            s = self.llm.model_shards
            return {"ok": True,
                    "k_shards": [_host(p) for p in torch.chunk(k, s, dim=1)],
                    "v_shards": [_host(p) for p in torch.chunk(v, s, dim=1)],
                    "next_token": nxt, "n_tokens": len(tokens)}
        return {"ok": True, "k": _host(k), "v": _host(v), "next_token": nxt,
                "n_tokens": len(tokens)}

    def _submit_seq(self, request):
        if self.engine is None:
            return {"ok": False, "error":
                    f"submit_seq on a {self.role} replica"}
        self._chaos_tick()
        if is_sharded_payload(request["payload"]):
            tokens, k, v, first = unpack_kv_sharded(request["payload"],
                                                    self.device)
        else:
            tokens, k, v, first = unpack_kv(request["payload"], self.device)
        self.engine.submit(
            int(request["rid"]), tokens,
            int(request["max_new_tokens"]), self.llm.eos_id,
            first_token=first, handoff=(k, v),
            front=bool(request.get("front")))
        return {"ok": True}

    def _generate(self, request):
        if self.engine is None:
            return {"ok": False, "error":
                    f"generate on a {self.role} replica"}
        self._chaos_tick()
        self.engine.submit(
            int(request["rid"]),
            [int(t) for t in request["tokens"]],
            int(request["max_new_tokens"]), self.llm.eos_id,
            front=bool(request.get("front")))
        return {"ok": True}


def _watch_parent(ppid: int) -> None:
    while True:
        time.sleep(0.5)
        if os.getppid() != ppid:
            log("warning", "llm replica: router process died; exiting")
            os._exit(0)


def main() -> int:
    replica_id = int(os.environ["HVD_SERVE_REPLICA_ID"])
    secret = bytes.fromhex(os.environ["HVD_SERVE_SECRET"])
    ready_file = os.environ["HVD_SERVE_READY_FILE"]
    role = os.environ.get("HVD_SERVE_LLM_ROLE", "both")
    ckpt = os.environ.get("HVD_SERVE_CHECKPOINT", "")
    # mode-local fallback (the pool manager always sets the envelope;
    # the `or` spelling keeps the authoritative default in
    # serving/replica.py per the config-registry convention)
    builder_spec = os.environ.get("HVD_SERVE_BUILDER") \
        or "horovod_tpu_torch.serving.model:lm_builder"
    llm_cfg = LLMConfig.from_env()

    from ...common.basics import resolve_device
    from ..model import (
        exact_float32,
        load_for_serving,
        resolve_builder,
        shard_lm_params,
    )

    # No card where one was asked for raises here, before any model code.
    device = resolve_device(os.environ.get("HVD_SERVE_DEVICE") or None)
    numerics = exact_float32(device)
    bind_device(device)
    builder = resolve_builder(builder_spec)
    state = load_for_serving(ckpt) if ckpt else None
    params = builder(state, device=device)
    if llm_cfg.model_shards > 1:
        # Every weight is dim-0-sliced 1/s per simulated chip (all on this
        # replica's card) and reassembled on access, so the scheduler and
        # decode math below run unchanged and token-for-token exact
        # against the unsharded model.
        params = shard_lm_params(params, llm_cfg.model_shards)
    per_chip = check_chip_budget(llm_cfg, params,
                                 with_cache=role in ("decode", "both"))

    tracer = init_serve_tracer(f"llm-{role}-{replica_id}")
    engine = None
    if role in ("decode", "both"):
        cache = PagedKVCache(llm_cfg.num_blocks, llm_cfg.block_size,
                             int(params["dim"]),
                             watermark=llm_cfg.watermark,
                             model_shards=llm_cfg.model_shards,
                             prefix_cache=bool(llm_cfg.prefix_cache),
                             device=device)
        draft = None
        if llm_cfg.draft_k > 0:
            # Derived from the (seeded) target params, so every decode
            # replica — including a respawn after SIGKILL — drafts
            # identically; the verify loop keeps outputs bitwise the
            # target's either way.
            from ..model import draft_lm_params

            draft = draft_lm_params(params)
        engine = DecodeEngine(IterationScheduler(
            cache, params, max_active=llm_cfg.max_active,
            admission_window=llm_cfg.admission_window,
            tracer=tracer, draft_params=draft,
            draft_k=llm_cfg.draft_k)).start()
        # Stall watchdog on the decode loop: a
        # replica whose iterations stop progressing for
        # HOROVOD_STALL_CHECK_TIME names the stuck sequence ids and trips
        # a flight-recorder dump — long before the manager's blunt
        # HOROVOD_SERVE_REPLICA_TIMEOUT reap would notice.
        if not os.environ.get("HOROVOD_STALL_CHECK_DISABLE"):
            from ...common.config import _env_stall_check_time
            from ...metrics import StallWatchdog

            StallWatchdog(
                check_time_s=_env_stall_check_time(), rank=replica_id,
                on_warn=lambda stalled: _flight.get_flight().dump(
                    f"stall-{len(stalled)}seqs")
            ).add_source(engine.stall_infos)
    elif role != "prefill":
        raise ValueError(f"unknown HVD_SERVE_LLM_ROLE {role!r}")

    svc = LLMReplicaService(secret, role, params, engine, llm_cfg,
                            replica_id, device=device)
    svc.per_chip_bytes = per_chip
    svc.numerics = numerics
    ppid = os.getppid()
    threading.Thread(target=_watch_parent, args=(ppid,), daemon=True).start()

    tmp = ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"port": svc.port, "pid": os.getpid()}, f)
    os.rename(tmp, ready_file)
    log("info", f"llm replica {replica_id} ({role}) ready on port "
        f"{svc.port} (blocks={llm_cfg.num_blocks}x{llm_cfg.block_size}, "
        f"max_active={llm_cfg.max_active}, "
        f"model_shards={llm_cfg.model_shards}, "
        f"per_chip_bytes={per_chip}, device={device})")

    while True:
        time.sleep(3600)


if __name__ == "__main__":
    sys.exit(main())
