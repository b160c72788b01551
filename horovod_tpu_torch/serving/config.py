"""Serving configuration — every knob of the inference plane in one place:
the port's own copy of ``horovod_tpu.serving.config``, with the same
environment.

All knobs are environment variables with the ``HOROVOD_SERVE_`` prefix,
resolved once at server construction by :meth:`ServeConfig.from_env`;
programmatic overrides win over the environment so tests and benchmarks
can pin a config without mutating ``os.environ``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


def _f(name: str, default: float) -> float:
    return float(os.environ.get(name, "") or default)


def _i(name: str, default: int) -> int:
    return int(os.environ.get(name, "") or default)


@dataclass
class ServeConfig:
    # -- frontend -----------------------------------------------------------
    port: int = 8600          # HOROVOD_SERVE_PORT; 0 = pick a free port
    host: str = "127.0.0.1"   # HOROVOD_SERVE_HOST (same posture as metrics:
    #                           localhost-only unless explicitly widened)
    token: str = ""           # HOROVOD_SERVE_TOKEN; when set, POST /v1/infer
    #                           requires "Authorization: Bearer <token>"
    # -- continuous batcher -------------------------------------------------
    max_batch: int = 8        # HOROVOD_SERVE_MAX_BATCH: device batch cap
    max_wait_ms: float = 5.0  # HOROVOD_SERVE_MAX_WAIT_MS: how long a forming
    #                           batch waits for companions before dispatch
    queue_cap: int = 1024     # HOROVOD_SERVE_QUEUE_CAP: admission backstop
    decode_steps: int = 1     # HOROVOD_SERVE_DECODE_STEPS: model steps per
    #                           dispatch (the scan-per-dispatch trick)
    # -- SLO-aware admission ------------------------------------------------
    slo_ms: float = 500.0     # HOROVOD_SERVE_SLO_MS: default per-request
    #                           deadline AND the load-shedding bound on the
    #                           projected queue wait
    # -- elastic replica autoscaling ---------------------------------------
    min_replicas: int = 1     # HOROVOD_SERVE_MIN_REPLICAS
    max_replicas: int = 4     # HOROVOD_SERVE_MAX_REPLICAS
    target_queue: float = 4.0  # HOROVOD_SERVE_TARGET_QUEUE: queued requests
    #                            per replica the autoscaler aims for
    cooldown_s: float = 10.0  # HOROVOD_SERVE_COOLDOWN_S: hysteresis between
    #                           scale actions (repair ignores it)
    # -- replica supervision ------------------------------------------------
    max_retries: int = 2      # HOROVOD_SERVE_MAX_RETRIES: re-dispatches of a
    #                           request whose replica died mid-batch
    replica_timeout_s: float = 30.0   # HOROVOD_SERVE_REPLICA_TIMEOUT: one
    #                                   infer round trip to a replica
    replica_start_timeout_s: float = 120.0  # HOROVOD_SERVE_START_TIMEOUT:
    #                                         spawn -> ready (torch import +
    #                                         checkpoint restore)
    blacklist_threshold: int = 1      # HOROVOD_SERVE_BLACKLIST_THRESHOLD:
    #                                   failures before a replica slot is
    #                                   blacklisted (ids are never reused)

    _ENV = {
        "port": "HOROVOD_SERVE_PORT",
        "host": "HOROVOD_SERVE_HOST",
        "token": "HOROVOD_SERVE_TOKEN",
        "max_batch": "HOROVOD_SERVE_MAX_BATCH",
        "max_wait_ms": "HOROVOD_SERVE_MAX_WAIT_MS",
        "queue_cap": "HOROVOD_SERVE_QUEUE_CAP",
        "decode_steps": "HOROVOD_SERVE_DECODE_STEPS",
        "slo_ms": "HOROVOD_SERVE_SLO_MS",
        "min_replicas": "HOROVOD_SERVE_MIN_REPLICAS",
        "max_replicas": "HOROVOD_SERVE_MAX_REPLICAS",
        "target_queue": "HOROVOD_SERVE_TARGET_QUEUE",
        "cooldown_s": "HOROVOD_SERVE_COOLDOWN_S",
        "max_retries": "HOROVOD_SERVE_MAX_RETRIES",
        "replica_timeout_s": "HOROVOD_SERVE_REPLICA_TIMEOUT",
        "replica_start_timeout_s": "HOROVOD_SERVE_START_TIMEOUT",
        "blacklist_threshold": "HOROVOD_SERVE_BLACKLIST_THRESHOLD",
    }

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        kw = {}
        for f in fields(cls):
            env = cls._ENV.get(f.name)
            raw = os.environ.get(env, "") if env else ""
            if f.name in overrides:
                kw[f.name] = overrides.pop(f.name)
            elif raw:
                # PEP 563 makes f.type a STRING here; resolve by name.
                t = f.type if isinstance(f.type, type) \
                    else {"int": int, "float": float, "str": str}.get(
                        str(f.type), str)
                kw[f.name] = t(raw)
        if overrides:
            raise TypeError(f"unknown ServeConfig overrides: "
                            f"{sorted(overrides)}")
        cfg = cls(**kw)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.decode_steps < 1:
            raise ValueError(
                f"decode_steps must be >= 1, got {self.decode_steps}")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        if self.slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {self.slo_ms}")


@dataclass
class LLMConfig:
    """Knobs of the token-level serving plane (``serving/llm/``,
    the JAX package's "Token-level serving"). Same contract as
    :class:`ServeConfig`: env-resolved once by :meth:`from_env`,
    programmatic overrides win, and :meth:`to_env` round-trips the
    resolved config into replica-process environments so pools agree on
    model shape and KV geometry without a side channel."""

    # -- paged KV cache (per decode replica) ---------------------------------
    block_size: int = 16      # HOROVOD_SERVE_LLM_BLOCK_SIZE: tokens/block
    num_blocks: int = 256     # HOROVOD_SERVE_LLM_NUM_BLOCKS: pool size
    watermark: float = 0.05   # HOROVOD_SERVE_LLM_WATERMARK: fraction of
    #                           blocks reserved for running sequences'
    #                           growth; admissions never touch it
    # -- iteration-level scheduler -------------------------------------------
    max_active: int = 8       # HOROVOD_SERVE_LLM_MAX_ACTIVE: decode batch
    #                           slot cap (memory is the real bound)
    max_new_tokens: int = 32  # HOROVOD_SERVE_LLM_MAX_TOKENS: default and
    #                           cap for a request's generated tokens
    admission_window: int = 64  # HOROVOD_SERVE_LLM_ADMISSION_WINDOW:
    #                             iterations a queued prefill may starve
    #                             before force-admission preempts the
    #                             newest running sequence
    eos_id: int = -1          # HOROVOD_SERVE_LLM_EOS: retire-on-token id
    #                           (-1 = only max_tokens retires)
    # -- prefill/decode disaggregation ---------------------------------------
    prefill_replicas: int = 1  # HOROVOD_SERVE_LLM_PREFILL_REPLICAS
    decode_replicas: int = 1   # HOROVOD_SERVE_LLM_DECODE_REPLICAS
    colocated: int = 0         # HOROVOD_SERVE_LLM_COLOCATED: 1 = one
    #                            both-role pool, prefill runs inside the
    #                            decode engine (same-process fast path)
    # -- SLOs -----------------------------------------------------------------
    slo_ms: float = 30000.0    # HOROVOD_SERVE_LLM_SLO_MS: default
    #                            end-to-end deadline for /v1/generate
    ttft_slo_ms: float = 2000.0  # HOROVOD_SERVE_LLM_TTFT_SLO_MS: the
    #                              admission budget — shed when projected
    #                              block wait exceeds it
    # -- reference model shape (TinyLM builder contract) ---------------------
    vocab: int = 64            # HOROVOD_SERVE_LLM_VOCAB
    dim: int = 16              # HOROVOD_SERVE_LLM_DIM
    max_context: int = 512     # HOROVOD_SERVE_LLM_MAX_CONTEXT
    seed: int = 0              # HOROVOD_SERVE_LLM_SEED
    # -- decode-side critical path -------------------------------------------
    draft_k: int = 0           # HOROVOD_SERVE_LLM_DRAFT_K: speculative
    #                            decoding — draft tokens proposed per
    #                            iteration for the target to verify
    #                            (0 = off). Output is bitwise unchanged.
    prefix_cache: int = 0      # HOROVOD_SERVE_LLM_PREFIX_CACHE: 1 = radix
    #                            prefix sharing over KV blocks (repeated
    #                            system prompts prefill once, COW guarded)
    stream: int = 0            # HOROVOD_SERVE_LLM_STREAM: 1 = default
    #                            /v1/generate responses to chunked JSONL
    #                            streaming (per-request "stream" wins)
    # -- multi-chip mesh replicas ---------------------------------------------
    model_shards: int = 1      # HOROVOD_SERVE_LLM_MODEL_SHARDS: chips per
    #                            replica group; every weight and KV page
    #                            is dim-sliced 1/s per chip, reassembled
    #                            on access (token-for-token exact)
    chip_budget: int = 0       # HOROVOD_SERVE_LLM_CHIP_BUDGET_BYTES:
    #                            per-chip persistent byte ceiling (params
    #                            slice + KV slice); 0 = unenforced. A
    #                            replica whose per-chip footprint exceeds
    #                            it refuses to start — the gate the
    #                            oversized-model smoke frames so the 2-D
    #                            plane provably cannot serve the model

    _ENV = {
        "block_size": "HOROVOD_SERVE_LLM_BLOCK_SIZE",
        "num_blocks": "HOROVOD_SERVE_LLM_NUM_BLOCKS",
        "watermark": "HOROVOD_SERVE_LLM_WATERMARK",
        "max_active": "HOROVOD_SERVE_LLM_MAX_ACTIVE",
        "max_new_tokens": "HOROVOD_SERVE_LLM_MAX_TOKENS",
        "admission_window": "HOROVOD_SERVE_LLM_ADMISSION_WINDOW",
        "eos_id": "HOROVOD_SERVE_LLM_EOS",
        "prefill_replicas": "HOROVOD_SERVE_LLM_PREFILL_REPLICAS",
        "decode_replicas": "HOROVOD_SERVE_LLM_DECODE_REPLICAS",
        "colocated": "HOROVOD_SERVE_LLM_COLOCATED",
        "slo_ms": "HOROVOD_SERVE_LLM_SLO_MS",
        "ttft_slo_ms": "HOROVOD_SERVE_LLM_TTFT_SLO_MS",
        "vocab": "HOROVOD_SERVE_LLM_VOCAB",
        "dim": "HOROVOD_SERVE_LLM_DIM",
        "max_context": "HOROVOD_SERVE_LLM_MAX_CONTEXT",
        "seed": "HOROVOD_SERVE_LLM_SEED",
        "draft_k": "HOROVOD_SERVE_LLM_DRAFT_K",
        "prefix_cache": "HOROVOD_SERVE_LLM_PREFIX_CACHE",
        "stream": "HOROVOD_SERVE_LLM_STREAM",
        "model_shards": "HOROVOD_SERVE_LLM_MODEL_SHARDS",
        "chip_budget": "HOROVOD_SERVE_LLM_CHIP_BUDGET_BYTES",
    }

    @classmethod
    def from_env(cls, **overrides) -> "LLMConfig":
        kw = {}
        for f in fields(cls):
            raw = os.environ.get(cls._ENV.get(f.name, ""), "")
            if f.name in overrides:
                kw[f.name] = overrides.pop(f.name)
            elif raw:
                t = f.type if isinstance(f.type, type) \
                    else {"int": int, "float": float, "str": str}.get(
                        str(f.type), str)
                kw[f.name] = t(raw)
        if overrides:
            raise TypeError(f"unknown LLMConfig overrides: "
                            f"{sorted(overrides)}")
        cfg = cls(**kw)
        cfg.validate()
        return cfg

    def to_env(self) -> dict:
        """The resolved config as the env contract a replica process
        re-reads with :meth:`from_env` — how the router pins programmatic
        overrides (tests, benchmarks) across the process boundary."""
        return {env: str(getattr(self, name))
                for name, env in self._ENV.items()}

    def usable_blocks(self) -> int:
        """Blocks an ADMISSION may claim (total minus the watermark
        reserve) — the bound a request's prompt+max_tokens must fit for
        the lone-sequence-always-completes guarantee to hold."""
        import math

        return self.num_blocks - int(math.ceil(
            self.num_blocks * self.watermark))

    def validate(self) -> None:
        if self.block_size < 1 or self.num_blocks < 1:
            raise ValueError(
                f"need block_size >= 1 and num_blocks >= 1, got "
                f"{self.block_size}/{self.num_blocks}")
        if not 0.0 <= self.watermark < 1.0:
            raise ValueError(
                f"watermark must be in [0, 1), got {self.watermark}")
        if self.max_active < 1 or self.max_new_tokens < 1:
            raise ValueError(
                f"need max_active >= 1 and max_new_tokens >= 1, got "
                f"{self.max_active}/{self.max_new_tokens}")
        if self.decode_replicas < 1 or (not self.colocated
                                        and self.prefill_replicas < 1):
            raise ValueError(
                f"need decode_replicas >= 1 (and prefill_replicas >= 1 "
                f"unless colocated), got {self.prefill_replicas}/"
                f"{self.decode_replicas}")
        if self.slo_ms <= 0 or self.ttft_slo_ms <= 0:
            raise ValueError(
                f"SLOs must be > 0, got slo_ms={self.slo_ms} "
                f"ttft_slo_ms={self.ttft_slo_ms}")
        if self.model_shards < 1:
            raise ValueError(
                f"model_shards must be >= 1, got {self.model_shards}")
        if self.dim % self.model_shards:
            raise ValueError(
                f"model_shards ({self.model_shards}) must divide dim "
                f"({self.dim}): KV pages and weights are sliced "
                f"uniformly per chip")
        if self.chip_budget < 0:
            raise ValueError(
                f"chip_budget must be >= 0 (0 = unenforced), got "
                f"{self.chip_budget}")
        if self.draft_k < 0:
            raise ValueError(
                f"draft_k must be >= 0 (0 = speculation off), got "
                f"{self.draft_k}")
