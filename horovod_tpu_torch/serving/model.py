"""Replica-side model machinery: serving-checkpoint loading, builder
resolution, the K-steps-per-dispatch decode function, and TinyLM, the
reference LM of the token-level plane. The port's counterpart of
``horovod_tpu.serving.model``: the same functions and contracts, on torch
tensors with an explicit device.

A **builder** turns restored checkpoint state into what a replica serves:
``builder(state, device) -> apply_fn`` with ``apply_fn(x: [batch, ...]) ->
y`` for the request-level plane, or the TinyLM params dict for the
token-level plane. The port's builders take the replica's device, where
the JAX package's take the state alone. Replicas are separate processes,
so builders are named by an importable ``"module:function"`` spec rather
than passed as closures. :func:`mlp_builder` is the built-in for
``models.MLP`` serving checkpoints; real deployments point at their own
model module.

The router imports this module for the builder-spec validation only and
never touches the card: only replicas create tensors on a device.
"""

from __future__ import annotations

import importlib
import os
import re
import threading
from typing import Any, Callable, Mapping

import numpy as np
import torch


def load_for_serving(path: str, template: Any = None) -> Any:
    """Restore a serving checkpoint written by
    :func:`horovod_tpu_torch.checkpoint.export_for_inference`.

    Refuses a raw *training* checkpoint: optimizer state in the restored
    tree means the export step never ran — which also means per-rank batch
    statistics were never consolidated, so serving it would silently serve
    one rank's stats. The error names the fix."""
    from ..checkpoint import load_for_inference

    state = load_for_inference(path, template)
    if isinstance(state, dict) and "opt_state" in state:
        raise ValueError(
            f"checkpoint at {path!r} is a raw TRAINING checkpoint (it "
            "contains 'opt_state'): the serving plane refuses it because "
            "optimizer state was never stripped and per-rank batch "
            "statistics were never consolidated. Export it first with "
            "horovod_tpu_torch.checkpoint.export_for_inference(path, state) "
            "and serve the exported copy.")
    return state


def resolve_builder(spec: str) -> Callable:
    """``"pkg.module:function"`` -> the function. Import errors surface
    with the spec named (a typo'd builder must fail the replica loudly at
    startup, not at the first request)."""
    mod_name, sep, fn_name = spec.partition(":")
    if not sep or not mod_name or not fn_name:
        raise ValueError(
            f"builder spec {spec!r} must look like 'pkg.module:function'")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise ImportError(f"cannot import builder module {mod_name!r} "
                          f"(from spec {spec!r}): {e}") from e
    try:
        return getattr(mod, fn_name)
    except AttributeError as e:
        raise AttributeError(
            f"builder module {mod_name!r} has no attribute "
            f"{fn_name!r} (from spec {spec!r})") from e


def exact_float32(device: torch.device) -> dict:
    """Keep float32 products in float32 on ``device``: TF32 off for cuBLAS
    (``torch.backends.cuda.matmul.allow_tf32``, which sets the cuBLAS
    handle's math mode) and cuDNN, matmul precision ``"highest"``. The
    serving oracle contract (paged, batched and speculative decode bitwise
    the sequential oracle) holds only when both sides run the same
    operations in the same dtype. Returns the settings read back, which a
    replica reports in its ``stats``."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return {"allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def bind_device(device: torch.device) -> None:
    """Make ``device`` the calling thread's current CUDA device (a no-op on
    the CPU). The current device is per thread, so every thread of a
    replica that runs model code calls this first: the service's handler
    threads and the decode engine's thread."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


class DecodeFn:
    """``steps`` applications of ``apply_fn`` per call, each step fed the
    previous step's output (``y_k = f(y_{k-1})``, so the model's output must
    be shaped like its input): the JAX package's ``lax.scan`` per dispatch.

    On the card each input shape (a padding bucket) gets one CUDA graph,
    captured on its first call after a warm-up on a side stream, with
    static input and output buffers (as ``loop.py`` captures a training
    step); later calls copy the batch in and replay. A capture is the
    counterpart of an XLA recompile: ``compiles`` counts them, and the
    replica reports it for ``horovod_serve_recompiles_total``. On the CPU
    the steps run as a plain loop and ``compiles`` counts the distinct
    shapes, as the JAX replica counts retraces. On the card a call returns
    the graph's static output buffer, which the next call of the same
    shape overwrites: copy what you keep (the replica copies it to the
    host at once)."""

    def __init__(self, apply_fn: Callable, steps: int = 1,
                 device=None) -> None:
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        self.apply_fn = apply_fn
        self.steps = steps
        self.device = torch.device(device) if device is not None else None
        self.compiles = 0
        self._shapes: set = set()
        self._graphs: dict = {}

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.steps):
            x = self.apply_fn(x)
        return x

    def _capture(self, x: torch.Tensor) -> tuple:
        from ..loop import warmup_stream

        static_in = torch.zeros_like(x)
        static_in.copy_(x)
        side = warmup_stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            self._run(static_in)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_out = self._run(static_in)
        torch.cuda.synchronize(x.device)
        return graph, static_in, static_out

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        if self.device is not None:
            x = x.to(self.device)
        key = (tuple(x.shape), x.dtype)
        if key not in self._shapes:
            self._shapes.add(key)
            self.compiles += 1
        with torch.no_grad():
            if x.device.type != "cuda":
                return self._run(x)
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(x)
            graph, static_in, static_out = entry
            static_in.copy_(x)
            graph.replay()
            return static_out


def make_decode_fn(apply_fn: Callable, steps: int = 1,
                   device=None) -> DecodeFn:
    """``apply_fn`` run ``steps`` times per call (:class:`DecodeFn`)."""
    return DecodeFn(apply_fn, steps, device)


def shard_batch(x, device) -> torch.Tensor:
    """The host batch on the replica's one card (the port runs one process
    per GPU, where a JAX replica lays the batch out over its local
    devices)."""
    return torch.as_tensor(x).to(torch.device(device))


# -- token-level serving: the reference LM + the paged decode step ----------
#
# TinyLM: a single-head attention LM whose paged-KV decode can be checked
# bitwise against a contiguous-cache oracle, and whose prefill/decode
# replicas — separate processes — derive identical weights from a seed
# with no checkpoint shipping. The weights are made in numpy exactly as
# the JAX package makes them (the same seed gives the same bits in both
# packages), then carried to the replica's device by
# :func:`lm_params_to_torch`; the model runs there in torch, greedy argmax
# (ties to the lowest index), so every token is a pure function of the
# prompt on a given device.


def tiny_lm_params(vocab: int = 64, dim: int = 16, max_context: int = 512,
                   seed: int = 0) -> dict:
    """Deterministic TinyLM weights as numpy float32 arrays, in the JAX
    package's layout: embedding, positional table, one attention head
    (wq/wk/wv) and the output head (wo). Same (vocab, dim, max_context,
    seed) -> bitwise-identical weights in every process and package."""
    rs = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(dim)
    return {
        "vocab": vocab, "dim": dim, "max_context": max_context,
        "embed": rs.uniform(-s, s, (vocab, dim)).astype(np.float32),
        "pos": rs.uniform(-s, s, (max_context, dim)).astype(np.float32),
        "wq": rs.uniform(-s, s, (dim, dim)).astype(np.float32),
        "wk": rs.uniform(-s, s, (dim, dim)).astype(np.float32),
        "wv": rs.uniform(-s, s, (dim, dim)).astype(np.float32),
        "wo": rs.uniform(-s, s, (dim, vocab)).astype(np.float32),
    }


def lm_params_to_torch(params, device) -> dict:
    """JAX-layout TinyLM params (numpy arrays, as :func:`tiny_lm_params`
    makes them) as the port's: each array a contiguous float32 tensor on
    ``device`` (the same layout: ``h @ w``), the scalars as they are."""
    device = torch.device(device)
    out = {}
    for key in params.keys():
        v = params[key]
        if isinstance(v, (np.ndarray, torch.Tensor)):
            out[key] = torch.as_tensor(v).to(
                device=device, dtype=torch.float32).contiguous()
        else:
            out[key] = v
    return out


def _lm_softmax(x: torch.Tensor) -> torch.Tensor:
    e = torch.exp(x - x.max())
    return e / e.sum()


def _scale(dim: int) -> float:
    # float32's sqrt, as the JAX package divides by np.float32(sqrt(dim))
    return float(np.float32(np.sqrt(dim)))


def lm_logits_step(params, token: int, pos: int, k_ctx, v_ctx) -> tuple:
    """:func:`lm_context_step` before its argmax: ``(logits, k_vec,
    v_vec)`` for ``token`` at position ``pos`` attending over
    ``k_ctx``/``v_ctx`` (positions 0..pos-1) plus itself."""
    if pos >= len(params["pos"]):
        raise ValueError(f"position {pos} exceeds max_context "
                         f"{len(params['pos'])}")
    h = params["embed"][token] + params["pos"][pos]
    k = h @ params["wk"]
    v = h @ params["wv"]
    q = h @ params["wq"]
    ks = torch.cat([k_ctx, k[None]]) if len(k_ctx) else k[None]
    vs = torch.cat([v_ctx, v[None]]) if len(v_ctx) else v[None]
    att = _lm_softmax((ks @ q) / _scale(h.shape[0])) @ vs
    return (h + att) @ params["wo"], k, v


def lm_context_step(params, token: int, pos: int, k_ctx, v_ctx) -> tuple:
    """ONE decode step against an explicit gathered context — the
    decode-step fn the paged scheduler drives with block-table-gathered
    K/V (kv_cache.PagedKVCache.gather): feed ``token`` at position
    ``pos`` attending over ``k_ctx``/``v_ctx`` (positions 0..pos-1) plus
    itself; returns ``(next_token, k_vec, v_vec)`` where k/v are this
    position's cache entries. The emitted token crosses to the host here
    (one sync per step). Because the gather materializes the same values
    in the same order a contiguous cache holds, paged and contiguous
    decode are bitwise identical."""
    logits, k, v = lm_logits_step(params, token, pos, k_ctx, v_ctx)
    return int(logits.argmax()), k, v


_GEMM_ROWS_EXACT: dict = {}
_GEMM_LOCK = threading.Lock()


def _gemm_rows_exact(dim: int, device=None, rows: int = 5) -> bool:
    """Probe (once per dim, device and row count per process) whether a
    batched ``[rows, dim] @ [dim, dim]`` product gives bitwise the rows of
    the one-row products ``h @ w`` that :func:`lm_context_step` computes.
    cuBLAS runs a one-row product as GEMV and a batch as GEMM, which need
    not sum in the same order, so on the card this may well read False;
    the batched verify forward then DEGRADES to per-row projections rather
    than silently breaking the oracle contract."""
    device = torch.device(device if device is not None else "cpu")
    key = (dim, str(device), rows)
    ok = _GEMM_ROWS_EXACT.get(key)
    if ok is None:
        rs = np.random.RandomState(7)
        hm = torch.as_tensor(rs.uniform(-1, 1, (rows, dim)).astype(
            np.float32)).to(device)
        wm = torch.as_tensor(rs.uniform(-1, 1, (dim, dim)).astype(
            np.float32)).to(device)
        batched = hm @ wm
        ok = all(torch.equal(batched[i], hm[i].clone() @ wm)
                 for i in range(rows))
        with _GEMM_LOCK:
            _GEMM_ROWS_EXACT[key] = ok
    return ok


def lm_verify_chain(params, feed: int, proposals, pos0: int,
                    buf_k: torch.Tensor, buf_v: torch.Tensor,
                    eos_id: int = -1) -> list:
    """The target side of speculative decoding (Leviathan et al.,
    arXiv:2211.17192) as ONE chained call: feed ``feed`` at ``pos0``,
    then walk the draft's ``proposals`` first-mismatch-wins — each step
    checks the draft's guess against the target argmax; on a mismatch
    the target's own token is already the correct emission, so only the
    remaining guesses are discarded. Returns the emitted tokens (between
    1 and ``len(proposals) + 1`` of them) and fills ``buf_k``/``buf_v``
    rows ``pos0 .. pos0+len(out)-1`` in place.

    ``buf_k``/``buf_v`` (tensors on the params' device) must hold the
    gathered context in rows ``[:pos0]`` with capacity ``pos0 +
    len(proposals) + 1``. The fed chain is known up front (teacher forcing
    — ``feed`` plus the proposals), so the K/V/Q projections run as ONE
    batched product where :func:`_gemm_rows_exact` holds for this device
    and row count, and as per-row products otherwise; each step attends
    over ``buf[:pos+1]`` views. Both are bitwise :func:`lm_context_step`
    on the same values, so speculation inherits the oracle contract; with
    an empty proposal list this is exactly one plain decode step."""
    last = pos0 + len(proposals)
    if last >= len(params["pos"]):
        raise ValueError(f"position {last} exceeds max_context "
                         f"{len(params['pos'])}")
    embed, posv, wo = params["embed"], params["pos"], params["wo"]
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    dim = buf_k.shape[1]
    feeds = [int(feed)] + [int(t) for t in proposals]
    if _gemm_rows_exact(dim, buf_k.device, len(feeds)):
        idx = torch.tensor(feeds, dtype=torch.long, device=buf_k.device)
        hs = embed[idx] + posv[pos0:last + 1]
        kb, vb, qb = hs @ wk, hs @ wv, hs @ wq
        # q as a fresh vector, as lm_context_step's is: a row view of the
        # batch may sit at another alignment, which a GEMV may sum apart
        rows = [(hs[j], kb[j], vb[j], qb[j].clone())
                for j in range(len(feeds))]
    else:
        rows = []
        for j, t in enumerate(feeds):
            h = embed[t] + posv[pos0 + j]
            rows.append((h, h @ wk, h @ wv, h @ wq))
    scale = _scale(dim)
    out = []
    pos = pos0
    for j, (h, k, v, q) in enumerate(rows):
        # row j was fed feeds[j], which is committed iff every earlier
        # proposal matched — the loop only reaches j in that case, so
        # rows written to the buffer always belong to the real chain.
        buf_k[pos] = k
        buf_v[pos] = v
        att = _lm_softmax((buf_k[:pos + 1] @ q) / scale) @ buf_v[:pos + 1]
        nxt = int(((h + att) @ wo).argmax())
        out.append(nxt)
        pos += 1
        if nxt == eos_id or j >= len(proposals) or proposals[j] != nxt:
            break
    return out


def lm_draft_chain(params, feed: int, pos0: int,
                   steps: int, eos_id: int = -1) -> list:
    """The draft side of speculative decoding: up to ``steps`` greedy
    self-fed proposals from the EMBEDDING PATH alone —
    ``argmax((embed[tok] + pos[p]) @ wo)`` — no attention, no K/V, no
    state. The verify loop guarantees OUTPUT correctness regardless of what
    is proposed; the draft's only job is guessing the target's argmax, so
    it needs no bitwise contract and no KV scratch to rebuild on
    preemption. Stops early at ``eos_id``. Returns the proposed tokens."""
    if pos0 + steps - 1 >= len(params["pos"]):
        raise ValueError(f"position {pos0 + steps - 1} exceeds "
                         f"max_context {len(params['pos'])}")
    embed, posv, wo = params["embed"], params["pos"], params["wo"]
    out = []
    tok, pos = int(feed), pos0
    for _ in range(steps):
        nxt = int(((embed[tok] + posv[pos]) @ wo).argmax())
        out.append(nxt)
        pos += 1
        if nxt == eos_id:
            break
        tok = nxt
    return out


def _device_of(params) -> torch.device:
    return params["embed"].device


def lm_prefill(params, tokens) -> tuple:
    """Run the prompt through the model sequentially: returns
    ``(K, V, next_token)`` with K/V of shape ``[len(tokens), dim]`` on the
    params' device — the payload a prefill replica hands off to the decode
    pool (the last position's logits already name the first generated
    token, so TTFT is the prefill round trip)."""
    if not len(tokens):
        raise ValueError("prefill needs at least one prompt token")
    dim = params["dim"]
    n = len(tokens)
    dev = _device_of(params)
    ks = torch.zeros((n, dim), dtype=torch.float32, device=dev)
    vs = torch.zeros((n, dim), dtype=torch.float32, device=dev)
    nxt = -1
    for i, t in enumerate(tokens):
        nxt, ks[i], vs[i] = lm_context_step(params, int(t), i,
                                            ks[:i], vs[:i])
    return ks, vs, nxt


def lm_prefill_from(params, tokens, k_prefix, v_prefix) -> tuple:
    """Prefill resuming from cached K/V rows (radix prefix hit,
    kv_cache.RadixPrefixCache): positions ``0..len(k_prefix)-1`` are
    already materialized, so only positions ``len(k_prefix)..n-1`` run
    through the model. Returns ``(K_new, V_new, next_token)`` with K/V
    covering just the NEW positions. Bitwise :func:`lm_prefill` on those
    positions, because a position's K/V depends only on (token, position)
    and the attention gather sees the same values either way."""
    n = len(tokens)
    start = len(k_prefix)
    if not (0 <= start < n):
        raise ValueError(f"prefix covers {start} of {n} prompt positions "
                         f"(need at least one position to compute)")
    dim = params["dim"]
    dev = _device_of(params)
    ks = torch.zeros((n, dim), dtype=torch.float32, device=dev)
    vs = torch.zeros((n, dim), dtype=torch.float32, device=dev)
    if start:
        ks[:start] = torch.as_tensor(k_prefix).to(dev).reshape(start, dim)
        vs[:start] = torch.as_tensor(v_prefix).to(dev).reshape(start, dim)
    nxt = -1
    for i in range(start, n):
        nxt, ks[i], vs[i] = lm_context_step(params, int(tokens[i]), i,
                                            ks[:i], vs[:i])
    return ks[start:], vs[start:], nxt


def draft_lm_params(params) -> dict:
    """The DRAFT model for speculative decoding (scheduler.py verify loop;
    Leviathan et al., arXiv:2211.17192): the target's weights rounded
    through float16 and back (``.half().float()``, which rounds as numpy's
    ``astype(float16)`` does). Deterministic in every process, so
    prefill/decode replicas and kill->respawn recovery agree bitwise, while
    the verify loop guarantees the OUTPUT is the target's regardless.
    Materializes ``ShardedLMParams`` transparently."""
    out = {}
    for key in params.keys():
        v = params[key]
        out[key] = v.half().float() if isinstance(v, torch.Tensor) else v
    return out


def lm_generate(params, prompt, max_new_tokens: int,
                eos_id: int = -1) -> list:
    """The sequential oracle: greedy generation over a contiguous cache,
    no paging, no batching, no scheduler. The serving plane must
    reproduce this token-for-token for every request — ANY cross-sequence
    KV contamination, block-table corruption, or preempt/resume drift
    changes some argmax and diverges from it."""
    k, v, nxt = lm_prefill(params, prompt)
    out = [nxt]
    ks, vs = list(k), list(v)
    while nxt != eos_id and len(out) < max_new_tokens:
        pos = len(ks)
        nxt, kv_k, kv_v = lm_context_step(
            params, out[-1], pos, torch.stack(ks), torch.stack(vs))
        ks.append(kv_k)
        vs.append(kv_v)
        out.append(nxt)
    return out


def lm_params_nbytes(params) -> int:
    """Persistent parameter bytes of a TinyLM params dict (tensors only;
    the scalars are free)."""
    return int(sum(params[k].numel() * params[k].element_size()
                   for k in params.keys()
                   if isinstance(params[k], torch.Tensor)))


class ShardedLMParams:
    """A TinyLM sharded across a serving replica's model axis — dict-like,
    so the scheduler's decode step and ``lm_prefill``/``lm_context_step``
    run UNCHANGED against it.

    Each of the ``model_shards`` simulated chips persistently holds a 1/s
    row-slice of every weight, all of them on the replica's one card;
    ``__getitem__`` reassembles the full tensor on access (one
    ``torch.cat`` — the simulated all-gather) and the reassembled tensor
    is BITWISE the original, so sharded serving is token-for-token exact
    by construction. Per-chip PERSISTENT bytes (:meth:`per_chip_nbytes`)
    is what the chip-budget gate counts."""

    def __init__(self, shards) -> None:
        shards = list(shards)
        if not shards:
            raise ValueError("need at least one shard")
        keys = set(shards[0])
        if any(set(s) != keys for s in shards):
            raise ValueError("shards disagree on param keys")
        self._shards = shards

    @property
    def model_shards(self) -> int:
        return len(self._shards)

    def __getitem__(self, key):
        v = self._shards[0][key]
        if not isinstance(v, torch.Tensor):
            return v            # replicated scalar (vocab/dim/max_context)
        if len(self._shards) == 1:
            return v
        return torch.cat([s[key] for s in self._shards], dim=0)

    def __contains__(self, key) -> bool:
        return key in self._shards[0]

    def get(self, key, default=None):
        return self[key] if key in self else default

    def keys(self):
        return self._shards[0].keys()

    def shard(self, rank: int) -> dict:
        """One chip's persistent slice tree."""
        return self._shards[rank]

    def per_chip_nbytes(self) -> int:
        """Persistent parameter bytes the LARGEST chip holds — the figure
        the HOROVOD_SERVE_LLM_CHIP_BUDGET_BYTES gate checks."""
        return max(lm_params_nbytes(s) for s in self._shards)


def shard_lm_params(params, model_shards: int) -> ShardedLMParams:
    """Slice a full TinyLM params dict into ``model_shards`` per-chip row
    slices (every weight's dim 0: embed/pos rows, wq/wk/wv/wo input rows),
    each its own tensor. Row-slicing makes the access-time gather a plain
    concatenate — bitwise exact — and every dim-0 size (vocab, dim,
    max_context) must divide evenly."""
    if model_shards < 1:
        raise ValueError(f"model_shards must be >= 1, got {model_shards}")
    if model_shards == 1:
        return ShardedLMParams([params])
    for key in params.keys():
        v = params[key]
        if isinstance(v, torch.Tensor) and v.shape[0] % model_shards:
            raise ValueError(
                f"param {key!r} dim 0 ({v.shape[0]}) not divisible by "
                f"model_shards {model_shards}: sharded serving slices "
                f"must be uniform")
    shards = []
    for r in range(model_shards):
        shard = {}
        for key in params.keys():
            v = params[key]
            if isinstance(v, torch.Tensor):
                per = v.shape[0] // model_shards
                shard[key] = v[r * per:(r + 1) * per].clone()
            else:
                shard[key] = v
        shards.append(shard)
    return ShardedLMParams(shards)


def lm_builder(state: Any, device=None) -> dict:
    """Builder for the LLM serving plane (``HVD_SERVE_BUILDER`` default
    for llm replicas): the TinyLM params as tensors on ``device`` (the card
    unless the caller asks for the CPU). A checkpointed state supplies
    ``state["lm_params"]``; with no checkpoint the weights derive from the
    HOROVOD_SERVE_LLM_{VOCAB,DIM,MAX_CONTEXT,SEED} env contract — which is
    how prefill and decode pool processes agree bitwise with zero weight
    shipping."""
    from ..common.basics import resolve_device

    device = resolve_device(device)
    if state is not None and "lm_params" in state:
        return lm_params_to_torch(state["lm_params"], device)
    return lm_params_to_torch(tiny_lm_params(
        vocab=int(os.environ.get("HOROVOD_SERVE_LLM_VOCAB", "") or 64),
        dim=int(os.environ.get("HOROVOD_SERVE_LLM_DIM", "") or 16),
        max_context=int(
            os.environ.get("HOROVOD_SERVE_LLM_MAX_CONTEXT", "") or 512),
        seed=int(os.environ.get("HOROVOD_SERVE_LLM_SEED", "") or 0)), device)


def _dense_names(params: Mapping) -> tuple:
    """(layer names in order, "flax" or "torch") of an MLP params tree:
    flax's ``{"Dense_i": {"kernel", "bias"}}`` or the port's state dict
    ``{"Dense_i.weight", "Dense_i.bias"}``."""
    flax = sorted((k for k in params if re.fullmatch(r"Dense_\d+", k)),
                  key=lambda k: int(k.split("_")[1]))
    if flax:
        return flax, "flax"
    port = sorted({k.split(".")[0] for k in params
                   if re.fullmatch(r"Dense_\d+\.weight", k)},
                  key=lambda k: int(k.split("_")[1]))
    return port, "torch"


def mlp_builder(state: Any, device=None) -> Callable:
    """Built-in builder for ``models.MLP`` serving checkpoints on
    ``device`` (the card unless the caller asks for the CPU). The params
    are the JAX package's flax tree (``Dense_i/kernel`` ``(in, out)``,
    carried across by ``convert.cnn_state_dict_from_jax``) or the port's
    own ``MLP.state_dict()``; layer widths are re-derived from the kernel
    shapes, so the replica needs no side-channel architecture file."""
    from ..common.basics import resolve_device
    from ..convert import cnn_state_dict_from_jax
    from ..models.mlp import MLP

    device = resolve_device(device)
    params = state["params"]
    names, layout = _dense_names(params)
    if not names:
        raise ValueError(
            f"mlp_builder: no Dense_* layers in params (keys: "
            f"{sorted(params)})")
    if layout == "flax":
        shapes = [tuple(params[k]["kernel"].shape) for k in names]
        in_features, features = shapes[0][0], [s[1] for s in shapes]
    else:
        shapes = [tuple(params[f"{k}.weight"].shape) for k in names]
        in_features, features = shapes[0][1], [s[0] for s in shapes]
    model = MLP(features=tuple(int(f) for f in features),
                in_features=int(in_features))
    if layout == "flax":
        sd = cnn_state_dict_from_jax(params, {}, model.state_dict().keys())
    else:
        sd = {k: torch.as_tensor(v) for k, v in params.items()}
    model.load_state_dict(sd)
    model = model.to(device).eval()

    def apply_fn(x):
        return model(torch.as_tensor(x, dtype=torch.float32).to(device))

    return apply_fn
