"""Shared pieces of the port's engine-matrix tests: the worker launch and
the canonical oracle digest, computed with the JAX package's
``_ring_order_reduce`` over the worker's seeded payloads (with the
enqueue-time quantize or top-k selection and error-feedback residuals)."""

from __future__ import annotations

import hashlib
import os

import numpy as np

from launch_util import REPO, launch_world

WORLD = 4
ELEMS = 30011  # odd: uneven ring chunks; ~120 KB f32 (topk-eligible)
STEPS = 3
WORKER = open(os.path.join(REPO, "tests",
                           "torch_port_engine_matrix_worker.py")).read()


def matrix_world(comp: str, plane: str, pkg="horovod_tpu_torch",
                 per_rank_pkg=None, extra=None, per_rank_env=None,
                 engine="python") -> list[dict]:
    """Every rank's output of one world: ``plane`` is ring, star or hier
    (2 fake hosts of 2 ranks); ``per_rank_pkg`` maps rank -> package for a
    mixed world; ``per_rank_env`` adds env per rank; ``engine`` is every
    rank's ``HOROVOD_ENGINE``."""
    env = {"HOROVOD_ENGINE": engine, "T_PKG": pkg, "T_COMP": comp,
           "T_ELEMS": str(ELEMS), "T_STEPS": str(STEPS),
           "HOROVOD_COMPRESSION": comp, "JAX_PLATFORMS": "cpu",
           "HOROVOD_RING_DATA_PLANE": "0" if plane == "star" else "1"}
    if plane == "hier":
        env.update({"T_LOCAL": "2", "T_HIER": "1",
                    "HOROVOD_HIERARCHICAL_ALLREDUCE": "1"})
    env.update(extra or {})
    per = {r: {} for r in range(WORLD)}
    for r, p in (per_rank_pkg or {}).items():
        per[r]["T_PKG"] = p
    for r, e in (per_rank_env or {}).items():
        per[r].update(e)
    return [r["out"] for r in launch_world(WORLD, WORKER, extra_env=env,
                                           per_rank_env=per)]


def oracle_digest(comp: str, grid=None) -> str:
    import ml_dtypes

    from horovod_tpu.common.engine import _ring_order_reduce
    from horovod_tpu.compression import topk_densify, topk_k, topk_select

    rng = np.random.default_rng(23)
    digest = hashlib.sha256()
    residuals: dict = {}
    for step in range(STEPS):
        name = f"g.{step % 2}"
        pay = [(rng.standard_normal(ELEMS) * (r + 1)).astype(np.float32)
               for r in range(WORLD)]
        if comp == "topk":
            prepared = []
            for r in range(WORLD):
                res = residuals.pop((name, r), None)
                x = pay[r] if res is None else pay[r] + res
                i, v = topk_select(x.ravel(), topk_k(x.size, 0.01))
                d = topk_densify(i, v, x.size)
                residuals[(name, r)] = x - d
                prepared.append(d)
            out = _ring_order_reduce(prepared, True, wire_dtype="topk",
                                     grid=grid)
        elif comp in ("bf16", "fp16"):
            wd = np.dtype(ml_dtypes.bfloat16 if comp == "bf16"
                          else np.float16)
            quant = [p.astype(wd).astype(np.float32) for p in pay]
            out = _ring_order_reduce(quant, True, wire_dtype=wd, grid=grid)
        else:
            out = _ring_order_reduce(pay, True, grid=grid)
        digest.update(np.ascontiguousarray(out).tobytes())
    return digest.hexdigest()
