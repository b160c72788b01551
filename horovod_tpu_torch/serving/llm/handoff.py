"""Prefill → decode KV handoff — the disaggregation wire format (the port's
counterpart of ``horovod_tpu.serving.llm.handoff``).

A prefill replica computes the prompt's K/V pages and the first generated
token; the router forwards that state to a decode replica as a
``submit_seq`` request over the same authenticated ``BasicService``
channel every replica already speaks (HMAC-framed, session-keyed —
runner/network.py). The payload is self-describing: contiguous
``[prompt_len, dim]`` float32 K and V arrays plus the token ids, which
the decode side re-pages into ITS OWN block allocator on admission
(kv_cache.PagedKVCache.load) — block ids are replica-local, so the
"block table" crosses the wire as the ordered page *contents*, not ids.

Pages cross the wire as host numpy float32: ``pack_kv`` and
``pack_kv_sharded`` copy them off the card (``.cpu().numpy()``), so the
router never holds a tensor of a device, and ``unpack_kv`` puts them back
on the decode replica's card. ``handoff_nbytes`` counts the same bytes as
the JAX package's for the same prompt.

When prefill and decode are colocated in one replica (role ``both``,
HOROVOD_SERVE_LLM_COLOCATED=1) none of this serializes: the sequence
prefills inside the decode engine itself — the same-process fast path,
counted as ``horovod_serve_llm_handoffs_total{path="local"}`` vs
``{path="wire"}``.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A page as contiguous host float32 (a tensor leaves its device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(a, dtype=np.float32)


def _check(ks: list, vs: list, n_tokens: int) -> None:
    if (not ks or len(ks) != len(vs)
            or any(p.ndim != 2 or p.shape != ks[0].shape for p in ks + vs)
            or len(ks[0]) != n_tokens):
        raise ValueError(
            f"malformed sharded KV payload: "
            f"k{[getattr(p, 'shape', None) for p in ks]} "
            f"v{[getattr(p, 'shape', None) for p in vs]} for "
            f"{n_tokens} tokens")


def pack_kv(tokens, k_arr, v_arr, first_token: int) -> dict:
    """The wire payload for one prefilled sequence. Pages are forced to
    contiguous host float32 so the byte count below is the true wire
    cost."""
    k = _host(k_arr)
    v = _host(v_arr)
    if k.shape != v.shape or k.ndim != 2 or len(k) != len(tokens):
        raise ValueError(
            f"malformed KV payload: k{k.shape} v{v.shape} for "
            f"{len(tokens)} tokens")
    return {"tokens": [int(t) for t in tokens], "k": k, "v": v,
            "first_token": int(first_token)}


def pack_kv_sharded(tokens, k_shards, v_shards, first_token: int) -> dict:
    """The wire payload for one prefilled sequence of a sharded replica:
    the pages cross the authenticated channel as per-model-shard
    dim-slices (``k_shards``/``v_shards`` lists of ``[prompt_len,
    dim/s]``), so the decode group's shards each land their own slice."""
    ks = [_host(p) for p in k_shards]
    vs = [_host(p) for p in v_shards]
    _check(ks, vs, len(tokens))
    return {"tokens": [int(t) for t in tokens], "k_shards": ks,
            "v_shards": vs, "first_token": int(first_token)}


def _to_device(a, device) -> torch.Tensor:
    from ...common.basics import resolve_device

    return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(
        resolve_device(device))


def unpack_kv_sharded(payload: dict, device=None) -> tuple:
    """-> (tokens, k_shards, v_shards, first_token) with the slices as
    tensors on ``device`` (the card unless the caller asks for the CPU);
    same loud-failure validation as :func:`unpack_kv`, per slice."""
    ks = [np.asarray(p, dtype=np.float32) for p in payload["k_shards"]]
    vs = [np.asarray(p, dtype=np.float32) for p in payload["v_shards"]]
    tokens = [int(t) for t in payload["tokens"]]
    _check(ks, vs, len(tokens))
    return (tokens, [_to_device(p, device) for p in ks],
            [_to_device(p, device) for p in vs], int(payload["first_token"]))


def is_sharded_payload(payload: dict) -> bool:
    return "k_shards" in payload


def handoff_nbytes(payload: dict) -> int:
    """Tensor bytes this handoff moves (token ids and framing are noise
    next to the pages). Sharded payloads count every slice — same total
    bytes as the dense format."""
    if is_sharded_payload(payload):
        return int(sum(p.nbytes for p in payload["k_shards"])
                   + sum(p.nbytes for p in payload["v_shards"]))
    return int(payload["k"].nbytes + payload["v"].nbytes)


def unpack_kv(payload: dict, device=None) -> tuple:
    """-> (tokens, k, v, first_token) with K and V as tensors on
    ``device`` (the card unless the caller asks for the CPU); validates
    shape agreement so a truncated/corrupted payload fails loudly at the
    decode side instead of decoding garbage context."""
    k = np.asarray(payload["k"], dtype=np.float32)
    v = np.asarray(payload["v"], dtype=np.float32)
    tokens = [int(t) for t in payload["tokens"]]
    if k.shape != v.shape or k.ndim != 2 or len(k) != len(tokens):
        raise ValueError(
            f"malformed KV payload: k{k.shape} v{v.shape} for "
            f"{len(tokens)} tokens")
    return (tokens, _to_device(k, device), _to_device(v, device),
            int(payload["first_token"]))
