"""The port's eager engine on 4-process worlds against the JAX package's,
bitwise: the flat ring and the star relay under every wire (``none``,
``fp16``, ``bf16``, ``topk``), each world's digest equal to the canonical
oracle digest computed with the JAX package's ``_ring_order_reduce``
(``tests/engine_matrix.py``), cold and cached (the third step reuses a
name and negotiates by cache bit); and mixed worlds that run the same
script (``tests/torch_port_engine_matrix_worker.py``) with the JAX
package's Python engine on some ranks: the JAX coordinator serving the
port's clients, and the port's coordinator serving the JAX clients, equal
to the same oracle. A star world under the bf16 wire is left out of the
mixed worlds: its uploads pickle each package's own bfloat16 array class.
Tolerance: none."""

from __future__ import annotations

import pytest

from engine_matrix import WORLD, matrix_world, oracle_digest

COMPS = ["none", "bf16", "fp16", "topk"]


@pytest.mark.parametrize("plane", ["ring", "star"])
@pytest.mark.parametrize("comp", COMPS)
def test_port_world_equals_the_oracle(comp, plane):
    outs = matrix_world(comp, plane)
    assert {o["hash"] for o in outs} == {oracle_digest(comp)}
    assert {o["plane"] for o in outs} == {plane}
    assert all(o["hits"] >= 1 for o in outs)       # step 3 rode the cache


MIXED = [("ring", "none"), ("ring", "bf16"), ("ring", "topk"),
         ("star", "fp16")]


@pytest.mark.parametrize("coordinator", ["horovod_tpu", "horovod_tpu_torch"])
@pytest.mark.parametrize("plane,comp", MIXED)
def test_mixed_world_equals_the_oracle(plane, comp, coordinator):
    other = ("horovod_tpu_torch" if coordinator == "horovod_tpu"
             else "horovod_tpu")
    per = {r: coordinator if r % 2 == 0 else other for r in range(WORLD)}
    outs = matrix_world(comp, plane, per_rank_pkg=per)
    assert {o["hash"] for o in outs} == {oracle_digest(comp)}
    assert {o["plane"] for o in outs} == {plane}
