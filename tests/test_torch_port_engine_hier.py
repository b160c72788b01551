"""The port's two-level eager plane (``_HierPlane``) on 4-process worlds
of 2 fake hosts x 2 ranks (``HOROVOD_HIERARCHICAL_ALLREDUCE=1``), every
wire, against the grid oracle digest computed with the JAX package's
``_ring_order_reduce(grid=(2, 2))``; and one JAX-engine world on the same
script, equal to it. Tolerance: none."""

from __future__ import annotations

import pytest

from engine_matrix import matrix_world, oracle_digest


@pytest.mark.parametrize("comp", ["none", "bf16", "fp16", "topk"])
def test_port_hier_world_equals_the_grid_oracle(comp):
    outs = matrix_world(comp, "hier")
    assert {o["hash"] for o in outs} == {oracle_digest(comp, grid=(2, 2))}
    assert {o["plane"] for o in outs} == {"hier"}


def test_jax_engine_on_the_same_script_equals_the_port():
    port = matrix_world("bf16", "hier")
    jax = matrix_world("bf16", "hier", pkg="horovod_tpu")
    assert {o["hash"] for o in port} == {o["hash"] for o in jax}
