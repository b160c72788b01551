"""The CUDA kernels against their plain versions, on the card: the flash
kernels (B1-B3) and the ring-flash kernels (B4-B6), the bf16 ones at every
built tile pair too; the sequence-parallel
training step over NCCL on every visible GPU; the CNN step on the card
against the CPU's; ResNet-50 data parallelism over NCCL on every visible
GPU (tests/torch_port_cnn_worker.py); the graphed training loop against
eager steps, on one card and over NCCL on every visible GPU
(tests/torch_port_graph_worker.py); remat against no remat on the card;
hierarchical data parallelism of ResNet-50 on a 2 x 2 layout of four GPUs
(tests/torch_port_hier_worker.py); Ulysses flash attention over NCCL on
every visible GPU against one whole-sequence call
(tests/torch_port_ulysses_worker.py); sharded data parallelism of the
full-width TransformerLM on four GPUs, ZeRO 2x2 and 1x4 and FSDP 4
against flat DP (tests/torch_port_sharded_worker.py); tensor parallelism
(tp = 4) and expert parallelism (ep = 4: ``moe_apply`` and the MoE
TransformerLM) at full width on four GPUs against one rank
(tests/torch_port_tp_worker.py); checkpoint and resume over NCCL on four
GPUs: save and restore with the cross-rank digest, ``save_sharded`` at
2x2 into 1x4 and flat, and an ``init(comm=[1, 3])`` sub-world
(tests/torch_port_ckpt_worker.py); ``autotune.tune`` over the ZeRO
layouts and the ladder of four GPUs laid out 2 x 2, each candidate's
updates against flat DP's (tests/torch_port_autotune_worker.py); elastic
training of the full-width TransformerLM on four GPUs, a worker killed and
respawned, against a run without a fault
(tests/torch_port_elastic_worker.py); the same elastic training across
two fake hosts of two cards each through the control tree's host leaders,
against the run without a fault and the flat control plane (``-k
ctrl_world``); the eager engine on four cards, one rank per card (``-k
engine_world``): the eager MNIST example at ``-np 4`` and phase 27's
engine worlds (tests/torch_port_engine_world_worker.py with ``init`` on
the card), flat and through the control tree's relays, every result
bitwise the canonical oracle, the engine's allreduce timed beside NCCL's.

Needs an NVIDIA Hopper GPU and nvcc; elsewhere every test skips. Run on
the card with (conftest.py imports jax, which the GPU machine need not
have)::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances, in float32: float32 outputs, the ring kernels' float32
carries included, agree to 1e-4 times the largest reference magnitude (or
1e-4, whichever is larger), the same sums in another order. bf16 outputs,
held against the plain version fed the same bf16 inputs, may differ by one
unit in the last place: |err| <= 2^-7 |ref| + 1e-2 times the rms of the
reference's row (its last dim), and the relative norm error is at most
1e-2. An output that is 0 in exact arithmetic (all of dQ and dK at T = 1,
and causal dQ's first row, whose one key gives dS = dP - delta = 0) comes
out as float32 noise on both sides, |x| <= 1e-4, which no relative rule
can compare. The NCCL world holds the sp step to slice 1's flash step on the whole
sequence: loss 1e-3 relative, every gradient 3e-2 relative norm error
(bf16 activations summed in another order across the ring). The CNN step
on the card (cuDNN, TF32 off) is held to the CPU's at
tests/test_torch_port_cnn.py's limits: logits and loss 1e-4 of
max(1, max|ref|) and BatchNorm statistics 1e-5 of max|ref| in float32,
and, in float64, every gradient to 1e-4 relative norm (in float32 a ReLU
input within rounding of 0 flips between the two and moves the gradient
below by far more). The graphed loop is held to the eager steps on the
same draws from the same weights with the same capturable Adam: every
loss and every parameter within 1e-6 relative (the same kernels in the
same order, so bit-equal is expected); remat to no remat, the same. The
hierarchical world holds the ladder's runs to the flat run: loss 1e-2
relative (phase 10's bf16 limit) and the updates of all parameters
together 3e-2 relative norm, about three times the bf16 DCN wire's reading
(9.13e-3; 3.65e-4 with no wire cast): four ranks sum in another order on
each tier. The Ulysses world expects bit
equality (the all-to-alls move data; each rank runs the same kernels on
the same rows) and otherwise holds the bf16 kernel rules above. The
sharded world holds each sharded run's updates of all parameters
together to flat DP's within 3e-2 relative norm (four ranks sum in
another order). The tp world holds each run's loss to the one-rank run's
within 1e-2 relative and every gradient (reassembled from the ranks'
slices) and ``moe_apply``'s output within 3e-2 relative norm. The
tracing world holds its traced steps bit-equal to the untraced ones (the
CUDA events change no value) and at least 80% of an injected 0.2 s sleep
in the sleeping rank's skew.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import ring_attention as ra
from horovod_tpu_torch.ops import ring_flash as rf
from launch_util import REPO, free_port

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(name, got, want, noise_rows=()):
    """``noise_rows``: rows (dim 1) that are 0 in exact arithmetic, held
    to float32 noise on both sides and left out of the relative rule."""
    assert got.dtype == want.dtype, name
    g, w = got.float(), want.float()
    if noise_rows:
        for x in (g, w):
            assert x[:, noise_rows].abs().max().item() <= 1e-4, name
        keep = torch.ones(g.shape[1], dtype=torch.bool, device=g.device)
        keep[list(noise_rows)] = False
        g, w = g[:, keep], w[:, keep]
    err = (g - w).abs()
    if want.dtype == torch.float32:
        assert err.max().item() <= 1e-4 * max(1.0, w.abs().max().item()), name
        return
    row_rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    assert bool((err <= 2.0 ** -7 * w.abs() + 1e-2 * row_rms).all()), \
        (name, err.max().item())
    assert (g - w).norm().item() <= 1e-2 * w.norm().item(), name


def _check(cuda, b, t, h, hkv, d, causal, dtype, seed=0, zero=(), tiles=(None, None)):
    """The kernels, at the tile ceilings ``tiles``, against their plain
    versions; outputs named in ``zero`` are 0 in exact arithmetic, and both
    sides must come out as float32 noise (|x| <= 1e-4), which no relative
    rule can compare; so must causal dQ's first row."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    q, k, v, g = rand(b, t, h, d), rand(b, t, hkv, d), rand(b, t, hkv, d), rand(b, t, h, d)
    qr, kr, vr, dor = fa._rows(q), fa._rows(k), fa._rows(v), fa._rows(g)
    out_p, lse_p = fa.fwd_plain(qr, kr, vr, h, hkv, causal)
    delta = (dor.float() * out_p.float()).sum(-1)
    want = {"o": out_p, "lse": lse_p,
            "dq": fa.dq_plain(qr, kr, vr, dor, lse_p, delta, h, hkv, causal)}
    want["dk"], want["dv"] = fa.dkv_plain(qr, kr, vr, dor, lse_p, delta, h, hkv, causal)
    got = {}
    got["o"], got["lse"] = fa.flash_fwd(qr, kr, vr, h, hkv, causal, *tiles)
    got["dq"] = fa.flash_bwd_dq(qr, kr, vr, dor, lse_p, delta, h, hkv, causal, *tiles)
    got["dk"], got["dv"] = fa.flash_bwd_dkv(qr, kr, vr, dor, lse_p, delta, h, hkv,
                                            causal, *tiles)
    torch.cuda.synchronize()
    for name in want:
        if name in zero:
            assert got[name].abs().max().item() <= 1e-4, name
            assert want[name].abs().max().item() <= 1e-4, name
        else:
            _assert_close(name, got[name], want[name],
                          [0] if causal and name == "dq" else ())


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, d, dtype):
    _check(cuda, 2, 256, 4, 4, d, True, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_ragged(cuda, causal):
    _check(cuda, 2, 96, 8, 2, 64, causal, torch.float32, seed=1)
    _check(cuda, 1, 200, 4, 1, 128, causal, torch.bfloat16, seed=2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 96, 200])
def test_bf16_tensor_core_kernels_ragged(cuda, t, d, causal):
    """The bf16 forward and dK/dV run on the tensor cores from TMA tiles
    of 128 rows: a T that no tile divides zero-fills past T, and no row
    reads its neighbour. At T = 1 each query sees one key, so p = 1 and
    dS = dP - delta = 0: dQ and dK vanish."""
    _check(cuda, 2, t, 4, 4, d, causal, torch.bfloat16, seed=t + d,
           zero=("dq", "dk") if t == 1 else ())


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_tensor_core_kernels_gqa(cuda, d):
    _check(cuda, 1, 256, 8, 2, d, True, torch.bfloat16, seed=5)
    _check(cuda, 2, 200, 8, 2, d, False, torch.bfloat16, seed=6)


# Every built tile pair as ceilings: each kernel built for a pair runs it.
TILE_CEILINGS = sorted({p for pairs in fa.TILE_PAIRS.values() for p in pairs})


@pytest.mark.parametrize("tiles", TILE_CEILINGS, ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("case", [
    # (b, t, h, hkv, causal)
    (1, 256, 8, 2, True),      # GQA, tiles of 64 and 128 across the diagonal
    (2, 200, 4, 2, True),      # ragged causal: the diagonal and the tail apart
    (2, 96, 4, 4, False),      # ragged, non-causal
    (2, 1, 4, 4, True),        # one row: dQ and dK vanish
], ids=["gqa", "ragged_causal", "ragged", "t1"])
def test_bf16_tile_pairs_match_plain(cuda, case, tiles):
    """B1-B3 at every built pair (head dim 128) against their plain
    versions, at the rules above; the pair each kernel ran is the one
    ``effective_blocks`` names, and each launched once."""
    b, t, h, hkv, causal = case
    eff = fa.effective_blocks(t, 128, torch.bfloat16, *tiles)
    assert all(eff[n] == tiles for n in fa.TILE_PAIRS if tiles in fa.TILE_PAIRS[n])
    fa.reset_launches()
    _check(cuda, b, t, h, hkv, 128, causal, torch.bfloat16, seed=t, tiles=tiles,
           zero=("dq", "dk") if t == 1 else ())
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def test_a_pair_not_built_raises(cuda):
    """A ceiling resolves to a built pair; a pair the library was not built
    for, passed to the entry point itself, is refused (kBadArgs), and the
    wrapper raises: nothing runs in its place."""
    q = torch.randn(1, 128, 2, 128, device=cuda).to(torch.bfloat16)
    qr = fa._rows(q)
    out, lse = torch.empty_like(qr), torch.empty(2, 128, device=cuda)
    fa.reset_launches()
    for code, (bq, bk) in ((1, (128, 32)), (1, (192, 64)), (0, (128, 128))):
        x = qr if code else qr.float()
        with pytest.raises(RuntimeError, match="arguments no kernel takes"):
            fa._launch(fa._library().hvd_flash_fwd, "flash_fwd", cuda,
                       fa._ptr(x), fa._ptr(x), fa._ptr(x), fa._ptr(out), fa._ptr(lse),
                       2, 2, 2, 128, 128, 1, code, bq, bk)
    assert fa.launches["flash_fwd"] == 0


def test_bf16_tensor_core_kernels_reject_unaligned_inputs(cuda):
    """TMA needs 16-byte aligned bases: a bf16 tensor whose storage
    offset breaks that raises, and nothing launches (B1-B6; B4 and B5 also
    for k positions, which they load by TMA). No FMA kernel and no plain
    version runs in its place."""
    b, t, h, d = 1, 64, 1, 64
    flat = torch.randn(b * t * h * d + 1, device=cuda).to(torch.bfloat16)
    q = flat[1:].view(b, t, h, d)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = torch.randn(b, t, h, d, device=cuda).to(torch.bfloat16)
    fa.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(fa._rows(q), fa._rows(k), fa._rows(k), h, h, True)
    lse = torch.zeros(b * h, t, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dkv(fa._rows(q), fa._rows(k), fa._rows(k), fa._rows(k), lse,
                         lse, h, h, True)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dq(fa._rows(q), fa._rows(k), fa._rows(k), fa._rows(k), lse,
                        lse, h, h, True)
    assert sum(fa.launches.values()) == 0
    rf.reset_launches()
    pos = rf.ring_positions(0, t, 1, False, cuda)
    carry = torch.zeros(b * h, t, d, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        rf.rf_bwd_dkv(fa._rows(q), fa._rows(k), fa._rows(k), fa._rows(k), lse, lse,
                      pos, pos, carry, carry.clone(), h, h)
    acc, m, l = rf.init_carries(b * h, t, d, cuda)
    with pytest.raises(ValueError, match="16-byte"):
        rf.rf_fwd(fa._rows(q), fa._rows(k), fa._rows(k), acc, m, l, pos, pos, h, h)
    with pytest.raises(ValueError, match="16-byte"):
        rf.rf_bwd_dq(fa._rows(q), fa._rows(k), fa._rows(k), fa._rows(k), lse, lse,
                     pos, pos, carry, h, h)
    kr = fa._rows(k)
    flat_pos = torch.zeros(t + 1, dtype=torch.int32, device=cuda)
    kpos = flat_pos[1:]
    assert kpos.is_contiguous() and kpos.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        rf.rf_fwd(kr, kr, kr, acc, m, l, pos, kpos, h, h)
    with pytest.raises(ValueError, match="16-byte"):
        rf.rf_bwd_dq(kr, kr, kr, kr, lse, lse, pos, kpos, carry, h, h)
    assert sum(rf.launches.values()) == 0


def test_autograd_counts_launches(cuda):
    fa.reset_launches()
    q = torch.randn(1, 128, 2, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device=cuda, requires_grad=True)
    v = torch.randn(1, 128, 2, 64, device=cuda, requires_grad=True)
    fa.flash_attention(q, k, v).sum().backward()
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def test_rejects_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 64, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    h = q[..., :32].to(torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(h, h, h)


# ------------------------------------------------------- ring-flash (B4-B6)

def _ring_check(cuda, b, t, h, hkv, d, dtype, my, src, zigzag, n=4, seed=0,
                tiles=(None, None)):
    """One ring step's three kernels, at the tile ceilings ``tiles``,
    against their plain versions on the same inputs and the same nonzero
    carries; returns the carries before."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=cuda).to(dt)

    r, rkv = b * h, b * hkv
    qr, kr, vr, dor = rand(r, t, d), rand(rkv, t, d), rand(rkv, t, d), rand(r, t, d)
    f32 = torch.float32
    carries = {"acc": rand(r, t, d, dt=f32), "m": rand(r, t, dt=f32),
               "l": 0.5 + torch.rand(r, t, generator=gen, device=cuda),
               "dq": rand(r, t, d, dt=f32), "dk": rand(rkv, t, d, dt=f32),
               "dv": rand(rkv, t, d, dt=f32)}
    lse = 1.0 + 2.0 * torch.rand(r, t, generator=gen, device=cuda)
    delta = rand(r, t, dt=f32)
    qpos = rf.ring_positions(my, t, n, zigzag, cuda)
    kpos = rf.ring_positions(src, t, n, zigzag, cuda)
    got = {k: v.clone() for k, v in carries.items()}
    want = {k: v.clone() for k, v in carries.items()}
    rf.rf_fwd(qr, kr, vr, got["acc"], got["m"], got["l"], qpos, kpos, h, hkv, *tiles)
    rf.rf_bwd_dq(qr, kr, vr, dor, lse, delta, qpos, kpos, got["dq"], h, hkv, *tiles)
    rf.rf_bwd_dkv(qr, kr, vr, dor, lse, delta, qpos, kpos, got["dk"], got["dv"], h,
                  hkv, *tiles)
    rf.rf_fwd_plain(qr, kr, vr, want["acc"], want["m"], want["l"], qpos, kpos, h, hkv)
    rf.rf_dq_plain(qr, kr, vr, dor, lse, delta, qpos, kpos, want["dq"], h, hkv)
    rf.rf_dkv_plain(qr, kr, vr, dor, lse, delta, qpos, kpos, want["dk"], want["dv"],
                    h, hkv)
    torch.cuda.synchronize()
    for name in carries:
        _assert_close(name, got[name], want[name])
    return carries, got


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_kernels_match_plain(cuda, d, dtype):
    _ring_check(cuda, 2, 128, 4, 4, d, dtype, my=1, src=1, zigzag=False)


@pytest.mark.parametrize("case", [
    # (b, t, h, hkv, d, dtype, my, src, zigzag)
    (2, 96, 4, 2, 32, torch.float32, 1, 2, True),       # ragged, zigzag
    (1, 256, 8, 2, 64, torch.bfloat16, 2, 1, False),    # GQA, every pair live
    (1, 200, 4, 1, 128, torch.bfloat16, 2, 2, True),    # ragged zigzag diagonal
    (1, 1024, 8, 8, 128, torch.bfloat16, 3, 0, True),   # zigzag past step
], ids=["ragged_zigzag", "gqa_past", "ragged_zigzag_diagonal", "zigzag_past"])
def test_ring_kernels_shapes(cuda, case):
    b, t, h, hkv, d, dtype, my, src, zigzag = case
    _ring_check(cuda, b, t, h, hkv, d, dtype, my, src, zigzag, seed=3)


@pytest.mark.parametrize("tiles", TILE_CEILINGS, ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("case", [
    # (b, t, h, hkv, my, src, zigzag)
    (1, 200, 4, 1, 2, 2, True),       # ragged zigzag diagonal
    (1, 256, 8, 2, 2, 1, False),      # GQA, every pair live
    (2, 96, 4, 2, 1, 1, False),       # ragged contiguous diagonal
    (1, 96, 4, 2, 0, 1, True),        # zigzag: some rows see no key
], ids=["ragged_zigzag_diagonal", "gqa_past", "ragged_diagonal", "zigzag_partial"])
def test_bf16_ring_tile_pairs_match_plain(cuda, case, tiles):
    """B4-B6 at every built pair (head dim 128) against their plain
    versions on one ring step of a ring of 4, each launched once."""
    b, t, h, hkv, my, src, zigzag = case
    rf.reset_launches()
    _ring_check(cuda, b, t, h, hkv, 128, torch.bfloat16, my, src, zigzag, seed=t,
                tiles=tiles)
    assert rf.launches == {"ring_flash_fwd": 1, "ring_flash_bwd_dq": 1,
                           "ring_flash_bwd_dkv": 1}


def test_ring_step_with_every_tile_skipped_keeps_the_carries(cuda):
    """Contiguous rank 0 against rank 3's block: every pair masked, so
    every tile pair is skipped inside the kernels and no carry moves."""
    assert ra.fully_masked(0, 3, 160, 4, False)
    before, got = _ring_check(cuda, 1, 160, 4, 2, 64, torch.float32, my=0,
                              src=3, zigzag=False)
    for name in before:
        assert torch.equal(got[name], before[name]), name


@pytest.mark.parametrize("d", [32, 64, 128])
def test_bf16_dq_and_ring_dkv_at_t_not_a_multiple_of_4(cuda, d):
    """B2 and B4-B6 on the tensor cores at T = 90: their TMA tiles
    zero-fill past T (k positions too, which B4 and B5 load by TMA), and
    rf_bwd_dkv pads L and delta to rows of 92 values for their TMA loads.
    Then a zigzag partial step at T = 96, where B4's and B5's 128-row q
    block and B6's 64-row q tile straddle the two 48-row stripes of the
    rank, with GQA."""
    _check(cuda, 2, 90, 4, 2, d, True, torch.bfloat16, seed=d)
    _check(cuda, 1, 90, 4, 2, d, False, torch.bfloat16, seed=d + 1)
    _ring_check(cuda, 1, 90, 4, 2, d, torch.bfloat16, my=2, src=2, zigzag=True, seed=d)
    _ring_check(cuda, 2, 90, 4, 2, d, torch.bfloat16, my=1, src=0, zigzag=False, seed=d + 1)
    _ring_check(cuda, 2, 96, 4, 2, d, torch.bfloat16, my=1, src=2, zigzag=True, seed=d + 2)


def test_bf16_ring_dkv_with_every_tile_skipped_keeps_the_carries(cuda):
    """B4, B5 and B6 on the tensor cores at a fully masked step: their
    producers and consumers skip every tile alike (no load, no wait, no
    turn in B4), each launch ends, and no carry moves."""
    before, got = _ring_check(cuda, 1, 160, 4, 2, 64, torch.bfloat16, my=0,
                              src=3, zigzag=False)
    for name in before:
        assert torch.equal(got[name], before[name]), name


@pytest.mark.parametrize("d", [32, 64, 128])
def test_bf16_ring_fwd_rows_with_no_live_key_keep_the_initial_carries(cuda, d):
    """B4 from the initial carries at a zigzag step (rank 0 of 4 against
    rank 1's block, T 96 in stripes of 48): rank 0's low stripe sees none
    of the block's keys, so those rows come back bit for bit, m -1e30, l 0
    and acc 0, while the high stripe's rows see every key. Then B5 on the
    finalized carries leaves those rows' dQ carry as it was."""
    b, t, h, hkv = 2, 96, 4, 2
    gen = torch.Generator(device=cuda).manual_seed(d)

    def rand(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=cuda).to(dt)

    qr, kr, vr, dor = rand(b * h, t, d), rand(b * hkv, t, d), rand(b * hkv, t, d), rand(b * h, t, d)
    qpos = rf.ring_positions(0, t, 4, True, cuda)
    kpos = rf.ring_positions(1, t, 4, True, cuda)
    dead = ~(qpos[:, None] >= kpos[None, :]).any(dim=1)
    assert int(dead.sum()) == 48
    want = list(rf.init_carries(b * h, t, d, cuda))
    got = [c.clone() for c in want]
    rf.rf_fwd_plain(qr, kr, vr, *want, qpos, kpos, h, hkv)
    rf.rf_fwd(qr, kr, vr, *got, qpos, kpos, h, hkv)
    torch.cuda.synchronize()
    acc, m, l = got
    assert bool((acc[:, dead] == 0).all())
    assert bool((m[:, dead] == rf.NEG_INF).all())
    assert bool((l[:, dead] == 0).all())
    for name, g, w in zip(("acc", "m", "l"), got, want):   # m's -1e30 aside
        _assert_close(name, g[:, ~dead], w[:, ~dead])
    out, lse = rf.finalize(*want, torch.bfloat16)
    delta = (dor.float() * out.float()).sum(-1)
    before = rand(b * h, t, d, dt=torch.float32)
    dq_got, dq_want = before.clone(), before.clone()
    args = (qr, kr, vr, dor, lse, delta, qpos, kpos)
    rf.rf_bwd_dq(*args, dq_got, h, hkv)
    rf.rf_dq_plain(*args, dq_want, h, hkv)
    torch.cuda.synchronize()
    assert torch.equal(dq_got[:, dead], before[:, dead])
    _assert_close("dq", dq_got, dq_want)


def test_bf16_ring_kernels_are_the_tensor_core_instances(cuda):
    """The ring library's bf16 entries reach the tensor-core kernels: its
    build log compiles fwd_tc_kernel, dq_tc_kernel and dkv_tc_kernel of
    variant 3 (kRing) at every head dim and built tile pair, and no FMA
    kernel in bf16 (the FMA templates are instantiated for float32 alone),
    so a bf16 ring launch has nowhere else to go."""
    import re

    from horovod_tpu_torch.ops import _build

    with open(_build.build("ring_flash.cu") + ".log") as f:
        entries = re.findall(r"Compiling entry function '(\S+)'", f.read())
    for template, name in (("fwd_tc_kernel", "ring_flash_fwd"),
                           ("dq_tc_kernel", "ring_flash_bwd_dq"),
                           ("dkv_tc_kernel", "ring_flash_bwd_dkv")):
        for d in (32, 64, 128):
            for bq, bk in fa.built_pairs(name, d, torch.bfloat16):
                mangled = f"{template}ILi{d}ELi3ELi{bq}ELi{bk}EE"
                assert any(mangled in e for e in entries), (template, d, bq, bk)
    fma = [e for e in entries if re.search(r"(fwd|dq|dkv)_kernelI", e)]
    assert fma and not any("bfloat16" in e for e in fma), fma
    rf.reset_launches()
    _ring_check(cuda, 1, 128, 2, 2, 64, torch.bfloat16, my=0, src=0, zigzag=False)
    assert rf.launches == {"ring_flash_fwd": 1, "ring_flash_bwd_dq": 1,
                           "ring_flash_bwd_dkv": 1}


def test_ring_autograd_counts_launches(cuda):
    rf.reset_launches()
    fa.reset_launches()
    q = torch.randn(1, 128, 2, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device=cuda, requires_grad=True)
    v = torch.randn(1, 128, 2, 64, device=cuda, requires_grad=True)
    rf.ring_flash_attention(q, k, v).sum().backward()
    assert rf.launches == {"ring_flash_fwd": 1, "ring_flash_bwd_dq": 1,
                           "ring_flash_bwd_dkv": 1}
    assert sum(fa.launches.values()) == 0


def test_ring_rejects_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 64, 2, 64, device=cuda)
    acc, m, l = rf.init_carries(2, 64, 64, cuda)
    pos = rf.ring_positions(0, 64, 1, False, cuda)
    qr = fa._rows(q)
    with pytest.raises(ValueError, match="int32"):
        rf.rf_fwd(qr, qr, qr, acc, m, l, pos.long(), pos, 2, 2)
    with pytest.raises(ValueError, match="float32"):
        rf.rf_fwd(qr, qr, qr, acc.double(), m, l, pos, pos, 2, 2)


# ------------------------------------------------------ the sp NCCL world

def _world(script: str, timeout: int, needs: int = 2, **env_extra):
    """One process per visible GPU running ``tests/<script>``; skips with
    fewer than ``needs`` GPUs. Returns (n, the cards' names and power
    limits, then rank 0's stdout)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < needs:
        pytest.skip(f"needs {needs} or more CUDA devices")
    n = torch.cuda.device_count()
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", **env_extra)
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
            env.pop(var, None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", script)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures, outs = [], []
    for rank, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failures.append(f"rank {rank} exit {proc.returncode}:\n{err[-3000:]}")
    assert not failures, "\n".join(failures)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return n, f"cards (name, power limit):\n{cards}{outs[0]}"


@pytest.fixture(scope="module")
def sp_world():
    return _world("torch_port_ring_worker.py", 900, RING_DEVICE="cuda")


def test_sp_world_step_matches_whole_sequence_step(sp_world):
    n, out = sp_world
    print(out)
    assert f"ok sp world {n}" in out


# ------------------------------------------------------------ the CNN zoo

def _cnn_step(model, images, labels):
    logits = model(images)
    loss = torch.nn.functional.cross_entropy(logits, labels)
    loss.backward()
    return (logits.detach().double().cpu(), loss.item(),
            {n: p.grad.double().cpu() for n, p in model.named_parameters()},
            {n: t.double().cpu() for n, t in model.state_dict().items()
             if "running" in n})


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cnn_step_on_the_card_matches_the_cpu(cuda, dtype):
    from horovod_tpu_torch.models.cnn_layers import BatchNorm
    from horovod_tpu_torch.train_cnn import CNNConfig, build_cnn, make_images

    config = CNNConfig(model="ResNet18", num_classes=10, image_size=64,
                       batch=4, dtype=dtype)
    base = build_cnn(config, "cpu")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():     # nonzero residual branches: random BN scales
        for m in base.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    images, labels = make_images(config, 0, "cpu")
    res = []
    for where in ("cpu", cuda):
        model = build_cnn(config, where)
        model.load_state_dict(base.state_dict())
        model = model.to(getattr(torch, dtype))
        res.append(_cnn_step(model, images.to(where), labels.to(where)))
    (want_logits, want_loss, want_grads, want_stats), \
        (logits, loss, grads, stats) = res
    limit = 1e-4 * max(1.0, want_logits.abs().max().item())
    assert (logits - want_logits).abs().max().item() <= limit
    assert abs(loss - want_loss) <= 1e-4 * max(1.0, abs(want_loss))
    for n, w in want_stats.items():
        assert (stats[n] - w).abs().max().item() <= 1e-5 * w.abs().max().item(), n
    if dtype == "float64":
        for n, w in want_grads.items():
            assert (grads[n] - w).norm().item() <= 1e-4 * w.norm().item(), n


@pytest.fixture(scope="module")
def sp_world_hooked():
    return _world("torch_port_ring_worker.py", 900, RING_DEVICE="cuda",
                  HOROVOD_LATENCY_HIDING="1")


def test_sp_world_hooked_step_matches_whole_sequence_step(sp_world_hooked):
    """The sp world with the DP exchange started from the gradient hooks:
    its all-reduces on the world's communicator run beside the ring's P2P
    on the sp group's."""
    n, out = sp_world_hooked
    print(out)
    assert f"ok sp world {n}" in out


@pytest.fixture(scope="module")
def cnn_world():
    return _world("torch_port_cnn_worker.py", 900, CNN_DEVICE="cuda")


def test_cnn_world_resnet50_data_parallel(cnn_world):
    n, out = cnn_world
    print(out)
    assert f"ok cnn world {n}" in out


# ---------------------------------------------------- the graphed loop

SMALL = dict(vocab=512, dim=256, heads=2, layers=2, seq=256)


def test_graphed_loop_matches_eager_steps(cuda, monkeypatch):
    """Two dispatches of K = 2 steps from one CUDA graph against four eager
    steps of the same step on the same draws; the flash kernels launch at
    capture only (one step's worth), the replays run them unseen."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import train
    from horovod_tpu_torch.loop import make_scan_train_loop

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        monkeypatch.delenv(var, raising=False)
    config = train.TrainConfig(**SMALL, steps_per_dispatch=2)
    try:
        s = train.setup(config, "cuda")
        cache = train.make_cache(config, None, cuda)
        loop = make_scan_train_loop(s.step, cache, 2, optimizer=s.opt)
        loop.warm_up()
        fa.reset_launches()
        got = []
        for _ in range(2):
            loop()
            got += loop.losses.tolist()
        assert fa.launches == {"flash_fwd": 2, "flash_bwd_dq": 2,
                               "flash_bwd_dkv": 2}
        e = train.setup(config, "cuda")
        ctr, want = cache.counter(), []
        for _ in range(4):
            x, y, ctr = cache.sample(ctr)
            want.append(e.step(x, y).item())
        for g, w in zip(got, want):
            assert abs(g - w) <= 1e-6 * abs(w), (got, want)
        for p, q in zip(s.model.parameters(), e.model.parameters()):
            assert (p - q).abs().max().item() <= 1e-6 * q.abs().max().item()
    finally:
        hvd.shutdown()


def _hooked_env(monkeypatch, hooks: bool, buckets: int = 4):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOROVOD_NUM_BUCKETS", str(buckets))
    monkeypatch.setenv("HOROVOD_LATENCY_HIDING", "1" if hooks else "0")


def test_hooked_exchange_matches_serial_on_the_card(cuda, monkeypatch):
    """HOROVOD_LATENCY_HIDING=1 against the serial exchange in a world of
    one over NCCL, 3 steps from the same weights: bit for bit in every loss
    and parameter, the last step's buckets started in the agreed order (a
    permutation of the plan's)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import train

    config = train.TrainConfig(**SMALL)
    runs = {}
    for hooks in (False, True):
        _hooked_env(monkeypatch, hooks)
        try:
            s = train.setup(config, "cuda")
            assert s.opt.latency_hiding == hooks
            tokens = train.make_batch(config, 0, cuda)
            losses = [s.step(tokens).item() for _ in range(3)]
            runs[hooks] = (losses, [p.detach().clone() for p in s.model.parameters()],
                           s.opt.last_launches, s.opt.launch_order,
                           s.opt.plan.num_buckets)
        finally:
            hvd.shutdown()
    (la, pa, _, _, _), (lb, pb, launches, order, nb) = runs[False], runs[True]
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert [b for b, _ in launches] == order and nb > 1
    assert sorted(order) == list(range(nb))


def test_graphed_loop_with_hooks_matches_eager_steps(cuda, monkeypatch):
    """The graphed loop with the hooks on (they fire in the warm-up on the
    side stream and again at capture) against eager steps with the hooks
    on, as test_graphed_loop_matches_eager_steps holds the serial one."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import train
    from horovod_tpu_torch.loop import make_scan_train_loop

    _hooked_env(monkeypatch, True)
    config = train.TrainConfig(**SMALL, steps_per_dispatch=2)
    try:
        s = train.setup(config, "cuda")
        cache = train.make_cache(config, None, cuda)
        loop = make_scan_train_loop(s.step, cache, 2, optimizer=s.opt)
        loop.capture()
        assert [b for b, _ in s.opt.last_launches] == s.opt.launch_order
        assert sorted(s.opt.launch_order) == list(range(s.opt.plan.num_buckets))
        got = []
        for _ in range(2):
            loop()
            got += loop.losses.tolist()
        e = train.setup(config, "cuda")
        ctr, want = cache.counter(), []
        for _ in range(4):
            x, y, ctr = cache.sample(ctr)
            want.append(e.step(x, y).item())
        for g, w in zip(got, want):
            assert abs(g - w) <= 1e-6 * abs(w), (got, want)
        for p, q in zip(s.model.parameters(), e.model.parameters()):
            assert (p - q).abs().max().item() <= 1e-6 * q.abs().max().item()
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_remat_matches_no_remat_on_the_card(cuda, attention):
    from horovod_tpu_torch import train
    from horovod_tpu_torch.models.transformer import lm_loss

    config = train.TrainConfig(**SMALL, attention=attention)
    tokens = train.make_batch(config, 0, cuda)
    res = []
    for remat in (True, False):
        model = train.build_model(dataclasses.replace(config, remat=remat), cuda)
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        res.append((loss.item(), [p.grad for p in model.parameters()]))
    (la, ga), (lb, gb) = res
    assert abs(la - lb) <= 1e-6 * abs(lb)
    for a, b in zip(ga, gb):
        assert (a - b).norm().item() <= 1e-6 * b.norm().item()


@pytest.fixture(scope="module")
def graph_world():
    return _world("torch_port_graph_worker.py", 600)


def test_graph_world_data_parallel_matches_eager(graph_world):
    n, out = graph_world
    print(out)
    assert f"ok graph dp world {n}" in out


def test_graph_world_sequence_parallel_matches_eager(graph_world):
    n, out = graph_world
    assert f"ok graph sp world {n}" in out


# ------------------------------------- hierarchical data parallelism, Ulysses

@pytest.fixture(scope="module")
def hier_world():
    return _world("torch_port_hier_worker.py", 900, needs=4, HIER_DEVICE="cuda")


def test_hier_world_resnet50_flat_vs_hierarchical(hier_world):
    """Full-width ResNet-50 on a 2 x 2 ('dcn', 'ici') layout of four cards,
    3 steps flat, hierarchical and hierarchical with a bf16 DCN wire, held
    to each other by phase 10's bf16 limits."""
    n, out = hier_world
    print(out)
    assert f"ok hier world {n}" in out


@pytest.fixture(scope="module")
def ulysses_world():
    return _world("torch_port_ulysses_worker.py", 900, ULY_DEVICE="cuda")


def test_ulysses_world_flash_matches_whole_sequence(ulysses_world):
    """Ulysses flash at (1, 16384, 8, 128) bf16 over every card against one
    whole-sequence flash_attention, and timed beside ring_flash_attention
    at the same sp."""
    n, out = ulysses_world
    print(out)
    assert f"ok ulysses world {n}" in out


# ------------------------------------------------ sharded data parallelism

@pytest.fixture(scope="module")
def sharded_world():
    return _world("torch_port_sharded_worker.py", 900, needs=4, SHARDED_MODE="cuda")


def test_sharded_world_zero_and_fsdp_match_flat_dp(sharded_world):
    """The full-width flash TransformerLM on four cards, 3 steps each of
    flat DP, ZeRO 2x2 and 1x4 and FSDP 4 from the same weights: all
    updates within 3e-2 relative norm of flat DP's, one reduce-scatter and
    one all-gather per bucket on the ZeRO paths; each rank's peak memory
    printed. Then ZeRO 2x2, ZeRO 1x4 and FSDP 4 graphed (K = 4, 2
    dispatches) against as many eager steps of the same setup: every loss,
    row and parameter within 1e-6 relative, the collectives at the capture
    one eager step's, none during the replays."""
    n, out = sharded_world
    print(out)
    assert f"ok sharded world {n}" in out


# ------------------------------------------------ tensor and expert parallelism

@pytest.fixture(scope="module")
def tp_world():
    return _world("torch_port_tp_worker.py", 900, needs=4, TP_MODE="cuda")


def test_tp_world_tensor_and_expert_parallel_match_one_rank(tp_world):
    """On four cards: the full-width flash TransformerLM at tp = 4, the
    full-width MoE TransformerLM at ep = 4 and ``moe_apply`` at ep = 4
    (dim 1024, hidden 4096, 8 experts, 4096 tokens a rank), each against
    the one-rank run; loss 1e-2 relative, gradients and outputs 3e-2
    relative norm (phase 5's bf16 limits)."""
    n, out = tp_world
    print(out)
    assert f"ok tp world {n}" in out


# ------------------------------------------------------ pipeline parallelism

@pytest.fixture(scope="module")
def pp_world():
    return _world("torch_port_pp_worker.py", 900, needs=4, PP_MODE="cuda")


def test_pp_world_pipeline_matches_flat(pp_world):
    """On four cards over NCCL, the full-width flash TransformerLM: pp = 4
    (3 blocks per stage, 4 microbatches of one sequence) against the flat
    model on the same 4 sequences, and pp 2 x sp 2 on ring flash (B4-B6)
    against the whole-sequence flat step; loss 1e-2 relative, every
    gradient 3e-2 relative norm (phase 5's bf16 limits); step ms and each
    rank's peak printed. Then pp = 4 graphed (K = 4, 2 dispatches) against
    as many eager steps: every loss and stage parameter within 1e-6
    relative, 12 P2P calls at the capture, none during the replays."""
    n, out = pp_world
    print(out)
    assert f"ok pp world {n}" in out


# ------------------------------------------- the exchange from the gradient hooks

@pytest.fixture(scope="module")
def overlap_world():
    return _world("torch_port_overlap_worker.py", 900, needs=4, OVERLAP_MODE="cuda")


def test_overlap_world_hooked_exchange_matches_serial(overlap_world):
    """On four cards over NCCL, the full-width flash TransformerLM with the
    exchange from the gradient hooks against the serial exchange, bit for
    bit in every loss and parameter: flat DP at 4 and 8 buckets, ZeRO 2x2,
    dp 2 x sp 2 on ring flash and dp 2 x pp 2; step ms per rank (flat DP at
    K = 1 serial, K = 4 and 8 hooked and serial) and ``measure_overlap``'s
    report printed."""
    n, out = overlap_world
    print(out)
    assert f"ok overlap world {n}" in out


# ------------------------------------------------------ checkpoint and resume

@pytest.fixture(scope="module")
def ckpt_world(tmp_path_factory):
    return _world("torch_port_ckpt_worker.py", 600, needs=4, CKPT_MODE="cuda",
                  CKPT_DIR=str(tmp_path_factory.mktemp("ckpt_world")),
                  CKPT_SUB_PORT=str(free_port()))


def test_ckpt_world_save_restore_sharded_and_subworld_over_nccl(ckpt_world):
    """On four cards over NCCL, each check bit for bit: ``save`` (the
    barrier with ``device_ids``) and ``restore(verify=True)`` in place, the
    digest raising on every rank when one rank's read is perturbed, the
    resume-state and object broadcasts, ``save_sharded`` at 2x2 restored
    into 1x4 and into the flat leaves, and ``init(comm=[1, 3])`` with each
    member on the GPU of its launched local rank."""
    n, out = ckpt_world
    print(out)
    assert f"ok ckpt world {n}" in out


# ------------------------------------------------------ tuning on four cards

@pytest.fixture(scope="module")
def autotune_world():
    return _world("torch_port_autotune_worker.py", 1200, needs=4,
                  AUTOTUNE_MODE="cuda")


def test_autotune_world_meshes_and_ladder_match_flat_dp(autotune_world):
    """On four cards over NCCL, laid out 2 x 2, the full-width flash
    TransformerLM: ``autotune.tune`` over ``mesh_shapes=("4x1", "2x2",
    "1x4")`` (ZeRO) and ``hierarchicals=(False, True)``, and over the flat
    optimizer with and without the ladder, each candidate's step ms per
    rank printed; every candidate's updates after 3 steps within 1e-2
    relative norm of flat DP's, the flat ladder's step-1 gradients within
    1e-5, ZeRO at 4x1 bit-equal to flat DP and ZeRO 2x2 to the flat
    ladder (tests/torch_port_autotune_worker.py)."""
    n, out = autotune_world
    print(out)
    assert f"ok autotune world {n}" in out


# ------------------------------------------------------ elastic on four cards

ELASTIC_STEPS = 6
ELASTIC_FAULT_STEP = 2
ELASTIC_STALL_S = 20
# The checkpointed run: construction is commit 1 and step i's commit is
# commit i + 1, so every 3rd commit checkpoints steps 2 and 5; rank 0 holds
# each write this long, past the stall time.
ELASTIC_CKPT_EVERY = 3
ELASTIC_CKPT_HOLD_S = ELASTIC_STALL_S + 5


def _elastic_job(tmp, name, index=None, checkpoint=False, elastic=True):
    """One job of tests/torch_port_elastic_worker.py's ``lm_train`` at full
    width on every visible card, over NCCL: through ``run_elastic``, task
    ``index`` killed at step 2's commit when given, checkpointing (rank
    0's writes held ``ELASTIC_CKPT_HOLD_S``) with ``checkpoint``; through
    ``run`` without ``elastic``. Returns (results, the parameters of each
    rank, the initial parameters, the driver's events)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.runner import run, run_elastic

    out = os.path.join(tmp, name)
    os.makedirs(out)
    events = os.path.join(out, "events.jsonl")
    env = {"PYTHONPATH": os.pathsep.join([os.path.join(REPO, "tests"), REPO]),
           "HOROVOD_STALL_SHUTDOWN_TIME": str(ELASTIC_STALL_S),
           "HOROVOD_ELASTIC_EVENT_LOG": events,
           "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "2"}
    if index is not None:
        env.update({"HOROVOD_FAULT_INJECT_STEP": str(ELASTIC_FAULT_STEP),
                    "HOROVOD_FAULT_INJECT_INDEX": str(index)})
    kwargs = {}
    if checkpoint:
        kwargs = {"checkpoint_dir": os.path.join(out, "ckpt"),
                  "checkpoint_every": ELASTIC_CKPT_EVERY}
        env.update({"HOROVOD_CKPT_ASYNC": "0", "HOROVOD_CKPT_TEST_STALL": "stage",
                    "HOROVOD_CKPT_TEST_STALL_S": str(ELASTIC_CKPT_HOLD_S)})
    n = torch.cuda.device_count()
    launch = run_elastic if elastic else run
    results = launch(worker.lm_train, args=("cuda", {}, ELASTIC_STEPS, out),
                     kwargs=kwargs, num_proc=n, timeout=900, env=env)
    params = [torch.load(os.path.join(out, f"params.{r}.pt"), weights_only=True)
              for r in range(n)]
    if not elastic:
        return results, params, None, []
    init = torch.load(os.path.join(out, "init.pt"), weights_only=True)
    import json

    with open(events) as f:
        log = [json.loads(line) for line in f]
    return results, params, init, log


@pytest.fixture(scope="module")
def elastic_world(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 or more CUDA devices")
    tmp = str(tmp_path_factory.mktemp("elastic"))
    runs = {"no fault": _elastic_job(tmp, "straight")}
    for index in (1, 0):
        runs[f"index {index} killed"] = _elastic_job(tmp, f"kill{index}",
                                                     index=index)
    runs["index 1 killed, checkpointed"] = _elastic_job(
        tmp, "kill1ckpt", index=1, checkpoint=True)
    plain = _elastic_job(tmp, "plain", elastic=False)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return runs, plain, cards


def test_elastic_world_survives_a_dead_worker_over_nccl(elastic_world):
    """``run_elastic`` of the full-width flash TransformerLM on four cards
    over NCCL, one rank per card, a commit after every step: once without a
    fault, then with task index 1, and then index 0 (rank 0, the host of the
    rendezvous store), killed at step 2's commit; then index 1 again with a
    checkpoint at every 3rd commit, rank 0 holding each write past
    HOROVOD_STALL_SHUTDOWN_TIME, so the other ranks must wait for it
    outside the process group's timeout. The survivors' next collective
    must raise ``HorovodInternalError`` within the stall time of the death
    (plus 15 s for the step and the commit around it, and the hold where
    the commit writes), and they must live on: each reports one reset, and
    the respawned worker joins generation 2 on the dead one's card (a
    checkpointed one cold-starts from step 2's checkpoint). Every rank ends
    at the exact step count with parameters bit-equal to the others' and
    to the run without a fault, and rank 0's losses equal that run's: the
    ranks of a new generation draw their batches by rank, and the sums
    run in rank order. The step's seconds (without the commit) of the run
    without a fault are printed beside those of the same job launched by
    ``run``, without the elastic settings."""
    runs, plain, cards = elastic_world
    print(f"cards (name, power limit):\n{cards}")
    straight, ref_params, _, _ = runs["no fault"]
    for label, (results, params, _, log) in runs.items():
        events = [e["event"] for e in log]
        failed = [e for e in log if e["event"] == "worker_failed"]
        gens = [e["generation"] for e in log if e["event"] == "rendezvous_complete"]
        print(f"{label}: events {events}")
        assert [r["step"] for r in results] == [ELASTIC_STEPS] * len(results)
        assert [r["rank"] for r in results] == list(range(len(results)))
        assert sorted(r["device"] for r in results) == list(range(len(results)))
        for r in results:
            print(f"  rank {r['rank']} on card {r['device']}: generation "
                  f"{r['generation']}, resumed from {r['resumed_from']}, losses "
                  f"{[round(x, 6) for x in r['losses']]}, resets "
                  f"{[(round(a - failed[0]['time_unix_s'], 2), round(b - a, 2)) for a, b in r['resets']]} "
                  "(s from the death to the raise, s from the raise to resumed)")
        differ = [k for k in ref_params[0]
                  if not all(torch.equal(p[k], ref_params[0][k]) for p in params)]
        print(f"  parameters: {len(differ)} of {len(ref_params[0])} differ "
              "from the run without a fault, on any rank")
        assert not differ, (label, differ[:5])
        assert results[0]["losses"] == straight[0]["losses"], label
        if label == "no fault":
            assert gens == [1] and not failed
            continue
        assert len(failed) == 1 and gens == [1, 2], (label, events)
        index = failed[0]["index"]
        survivors = [r for r in results if r["resets"]]
        (respawned,) = [r for r in results if not r["resets"]]
        assert len(survivors) == len(results) - 1, label
        assert respawned["device"] == index, (label, respawned["device"], index)
        hold = ELASTIC_CKPT_HOLD_S if "checkpointed" in label else 0
        assert respawned["resumed_from"] == (ELASTIC_FAULT_STEP if hold else 0)
        for r in survivors:
            (raised, resumed), = r["resets"]
            assert raised - failed[0]["time_unix_s"] <= ELASTIC_STALL_S + 15 + hold, \
                (label, r["rank"])
            assert resumed is not None
        assert all(r["generation"] == 2 for r in results)
    results, params, _, _ = plain
    for k in ref_params[0]:
        assert torch.equal(params[0][k], ref_params[0][k]), k
    elastic_s = sorted(s for r in straight for s in r["step_s"][1:])
    plain_s = sorted(s for r in results for s in r["step_s"][1:])
    print(f"step seconds (steps 2-{ELASTIC_STEPS}, every rank, without the "
          f"commit): median {elastic_s[len(elastic_s) // 2]:.4f} s under "
          f"run_elastic, {plain_s[len(plain_s) // 2]:.4f} s under run; all "
          f"{[round(x, 4) for x in elastic_s]} vs {[round(x, 4) for x in plain_s]}")


# ------------------------------------------------------ tracing on four cards

TRACING_STEPS, TRACING_SLEEP_RANK, TRACING_SLEEP_S = 5, 2, 0.2


@pytest.fixture(scope="module")
def tracing_world(tmp_path_factory):
    import json

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 or more CUDA devices")
    tmp = tmp_path_factory.mktemp("tracing_world")
    n, out = _world("torch_port_tracing_worker.py", 900, needs=4,
                    TRACING_MODE="world", TRACING_DEVICE="cuda",
                    TRACING_CFG=json.dumps({}), TRACING_STEPS=str(TRACING_STEPS),
                    TRACING_SLEEP_RANK=str(TRACING_SLEEP_RANK),
                    TRACING_SLEEP_S=str(TRACING_SLEEP_S),
                    TRACING_TRACE_DIR=str(tmp / "trace"),
                    TRACING_OUT=str(tmp / "out"),
                    TRACING_COORD_ADDR2=f"127.0.0.1:{free_port()}",
                    HOROVOD_LATENCY_HIDING="1")
    results = []
    for rank in range(n):
        with open(tmp / f"out.{rank}.json") as f:
            results.append(json.load(f))
    return n, out, results, str(tmp / "trace")


def test_tracing_world_attributes_the_sleep_and_times_the_buckets(tracing_world):
    """Four cards over NCCL, flat DP of the full-width flash TransformerLM
    with the exchange from the gradient hooks (14 buckets at 64 MiB), 5
    eager steps traced, rank 2 sleeping 0.2 s on the host before step 3's
    backward, against the same 5 steps untraced: bit-equal on every rank;
    every bucket's trace ID on all four ranks; ``analyze`` puts at least
    80% of the sleep into ``skew_seconds_by_rank[2]`` (the reference's
    acceptance rule). Printed: each bucket's device ms (its ``wire`` span,
    from the input ready to the end event) and its exposed ms (the part of
    the span after the backward's kernels ended on that rank), medians
    over the ranks and the steps other than the first and the sleeping
    one."""
    import statistics

    from horovod_tpu_torch.tracing import collector, critical_path

    n, out, results, trace_dir = tracing_world
    print(out)
    for r in results:
        assert r["bit_equal"] and r["traced_losses"] == r["plain_losses"], r["rank"]
    spans, metas = collector.load_spans(trace_dir)
    assert sorted(metas) == list(range(n))
    buckets = results[0]["buckets"]
    wires = {}
    for s in spans:
        if s["phase"] == "wire" and s["tid"].startswith("grad."):
            name, k = s["tid"].split("#")
            wires[(int(name[5:]), int(k), s["rank"])] = s
    for b in range(buckets):
        for k in range(1, TRACING_STEPS + 1):
            assert {r for (bb, kk, r) in wires if (bb, kk) == (b, k)} == \
                set(range(n)), (b, k)
    report = critical_path.analyze(spans)
    print(critical_path.format_summary(report))
    print(f"skew seconds by rank {report['skew_seconds_by_rank']}, "
          f"multi-rank collectives {report['multi_rank_collectives']}")
    assert report["skew_seconds_by_rank"].get(TRACING_SLEEP_RANK, 0) \
        >= 0.8 * TRACING_SLEEP_S
    steady = [k for k in range(2, TRACING_STEPS + 1) if k != 3]
    for b in range(buckets):
        dev_ms, exposed_ms = [], []
        for k in steady:
            for r in range(n):
                w = wires[(b, k, r)]
                end = results[r]["windows"][k - 1]["backward_end"]
                dev_ms.append((w["t1"] - w["t0"]) / 1e6)
                exposed_ms.append(max(0, w["t1"] - max(w["t0"], end)) / 1e6)
        print(f"bucket {b} ({w['bytes']} B): device ms median "
              f"{statistics.median(dev_ms):.4f} (min {min(dev_ms):.4f}, max "
              f"{max(dev_ms):.4f}), exposed after the backward median "
              f"{statistics.median(exposed_ms):.4f} ms")


# ------------------------------------------------ the control tree on four cards

def _fake_host(name: str, secret: bytes, cards: str):
    """An hvd-agent standing in for host ``name`` (HOROVOD_HOSTNAME) whose
    workers see ``cards`` (CUDA_VISIBLE_DEVICES); returns (process, port)."""
    import json
    import threading

    env = dict(os.environ, HOROVOD_HOSTNAME=name, HOROVOD_AGENT_SECRET=secret.hex(),
               CUDA_VISIBLE_DEVICES=cards,
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "tests"), REPO]))
    env.pop("HOROVOD_CTRL_TREE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.agent", "--port", "0"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, text=True)
    info = json.loads(proc.stdout.readline())
    assert info["agent"] == "ready", info
    # the workers it spawns share its stdout: keep the pipe drained
    threading.Thread(target=proc.stdout.read, daemon=True).start()
    return proc, info["port"]


def _ctrl_job(tmp, name, spec, secret, tree, index=None):
    """One ``run_elastic`` of tests/torch_port_elastic_worker.py's
    ``lm_train`` at full width across the fake hosts ``spec``, over NCCL,
    checkpointing at every 3rd commit (steps 2 and 5), task ``index``
    killed at step 2's commit when given; ``tree`` leaves
    HOROVOD_CTRL_TREE unset (the tree on), else sets it to 0. Returns
    (results, the parameters of each rank, the driver's events, the
    requests the driver handled as (kind, client address))."""
    import json
    import threading

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.runner import run_elastic
    from horovod_tpu_torch.runner import service

    out = os.path.join(tmp, name)
    os.makedirs(out)
    events = os.path.join(out, "events.jsonl")
    env = {"PYTHONPATH": os.pathsep.join([os.path.join(REPO, "tests"), REPO]),
           "HOROVOD_STALL_SHUTDOWN_TIME": str(ELASTIC_STALL_S),
           "HOROVOD_ELASTIC_EVENT_LOG": events,
           "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "2", "HOROVOD_CKPT_ASYNC": "0"}
    if index is not None:
        env.update({"HOROVOD_FAULT_INJECT_STEP": str(ELASTIC_FAULT_STEP),
                    "HOROVOD_FAULT_INJECT_INDEX": str(index)})
    base = service.ElasticDriverService
    seen, depth = [], threading.local()

    class Recording(base):
        def handle(self, req, client_addr):
            n = getattr(depth, "n", 0)
            if n == 0:
                seen.append((req.get("kind"), client_addr))
            depth.n = n + 1
            try:
                return super().handle(req, client_addr)
            finally:
                depth.n = n

    prev = os.environ.pop("HOROVOD_CTRL_TREE", None)
    if not tree:
        os.environ["HOROVOD_CTRL_TREE"] = "0"
    service.ElasticDriverService = Recording
    try:
        results = run_elastic(worker.lm_train, args=("cuda", {}, ELASTIC_STEPS, out),
                              kwargs={"checkpoint_dir": os.path.join(out, "ckpt"),
                                      "checkpoint_every": ELASTIC_CKPT_EVERY},
                              hosts=spec, agent_secret=secret, timeout=900, env=env)
    finally:
        service.ElasticDriverService = base
        os.environ.pop("HOROVOD_CTRL_TREE", None)
        if prev is not None:
            os.environ["HOROVOD_CTRL_TREE"] = prev
    params = [torch.load(os.path.join(out, f"params.{r}.pt"), weights_only=True)
              for r in range(len(results))]
    with open(events) as f:
        log = [json.loads(line) for line in f]
    return results, params, log, seen


@pytest.fixture(scope="module")
def ctrl_world(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 or more CUDA devices")
    tmp = str(tmp_path_factory.mktemp("ctrl"))
    secret = os.urandom(32)
    hosts = [_fake_host("a", secret, "0,1"), _fake_host("b", secret, "2,3")]
    try:
        spec = ",".join(f"127.0.0.1@{port}:2" for _, port in hosts)
        runs = {"no fault, tree": _ctrl_job(tmp, "straight", spec, secret, True),
                "index 3 killed, tree": _ctrl_job(tmp, "kill3", spec, secret, True,
                                                  index=3),
                "index 3 killed, flat": _ctrl_job(tmp, "kill3flat", spec, secret,
                                                  False, index=3)}
    finally:
        for proc, _ in hosts:
            proc.terminate()
        for proc, _ in hosts:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return runs, cards


def test_ctrl_world_elastic_through_the_host_leaders(ctrl_world):
    """``run_elastic`` of the full-width flash TransformerLM over NCCL on
    four cards, laid out as two fake hosts ``a`` and ``b`` of two cards each
    (hvd-agents with HOROVOD_HOSTNAME and CUDA_VISIBLE_DEVICES), with the
    control tree on by default, a checkpoint at steps 2 and 5, and task
    index 3 (host ``b``'s second slot) killed after step 2's commit: every
    rank at step 6 bit-equal to the run without a fault and to the same job
    under HOROVOD_CTRL_TREE=0, the respawned worker cold-started from step
    2's checkpoint on the dead one's card; with the tree, the driver saw
    one request connection per host (and one wait connection per host) and
    no registration but inside a host leader's ``host_register``."""
    runs, cards = ctrl_world
    print(f"cards (name, power limit):\n{cards}")
    straight, ref_params, _, _ = runs["no fault, tree"]
    for label, (results, params, log, seen) in runs.items():
        events = [e["event"] for e in log]
        failed = [e for e in log if e["event"] == "worker_failed"]
        gens = [e["generation"] for e in log if e["event"] == "rendezvous_complete"]
        kinds = {}
        for kind, addr in seen:
            kinds.setdefault(kind, set()).add(addr)
        print(f"{label}: events {events}; driver requests by kind (connections) "
              f"{ {k: len(v) for k, v in sorted(kinds.items())} }")
        assert [r["step"] for r in results] == [ELASTIC_STEPS] * 4
        assert [r["rank"] for r in results] == [0, 1, 2, 3]
        assert sorted(r["device"] for r in results) == [0, 0, 1, 1]
        for r in results:
            print(f"  rank {r['rank']} on card {r['device']} of its host: "
                  f"generation {r['generation']}, resumed from "
                  f"{r['resumed_from']}, losses {[round(x, 6) for x in r['losses']]}")
        differ = [k for k in ref_params[0]
                  if not all(torch.equal(p[k], ref_params[0][k]) for p in params)]
        print(f"  parameters: {len(differ)} of {len(ref_params[0])} differ from "
              "the run without a fault, on any rank")
        assert not differ, (label, differ[:5])
        assert results[0]["losses"] == straight[0]["losses"], label
        if "tree" in label:
            assert "register" not in kinds and "rendezvous" not in kinds, label
            request = set().union(*(v for k, v in kinds.items()
                                    if k != "host_wait_assignment"))
            assert len(request) == 2 and len(kinds["host_wait_assignment"]) == 2
        else:
            assert "host_register" not in kinds and kinds["register"], label
        if label.startswith("no fault"):
            assert gens == [1] and not failed
            continue
        assert len(failed) == 1 and gens == [1, 2], (label, events)
        (respawned,) = [r for r in results if r["generation"] == 2
                        and r["resumed_from"] == ELASTIC_FAULT_STEP]
        assert respawned["device"] == 1, label


# -- the eager engine on four cards ------------------------------------------------

@pytest.fixture(scope="module")
def engine_world(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 or more CUDA devices")
    import numpy as np
    import torch_port_engine_world_worker as W

    tmp = str(tmp_path_factory.mktemp("engine"))
    env = dict(os.environ, MNIST_EPOCHS="2", MNIST_STEPS="8", PYTHONPATH=REPO,
               HOROVOD_ENGINE="python")
    for var in ("HOROVOD_DEVICE_ORDINAL", "CUDA_VISIBLE_DEVICES"):
        env.pop(var, None)
    subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "4", "--",
         sys.executable, os.path.join(REPO, "examples", "torch_mnist_eager.py"),
         "--dump", os.path.join(tmp, "mnist")],
        env=env, cwd=REPO, check=True, timeout=900)
    mnist = [dict(np.load(os.path.join(tmp, "mnist", f"rank{r}.npz")))
             for r in range(4)]
    base = {"T_DEVICE": "cuda"}
    runs = {"ring": W.launch(os.path.join(tmp, "ring"),
                             dict(base, T_TIMED="3", T_DIST="1"), timeout=900)}
    secret = os.urandom(32)
    hosts = [_fake_host("a", secret, "0,1"), _fake_host("b", secret, "2,3")]
    try:
        spec = ",".join(f"127.0.0.1@{port}:2" for _, port in hosts)
        runs["relayed hier"] = W.launch(
            os.path.join(tmp, "hier"),
            dict(base, T_PLANES="hier"),
            hosts=spec, secret=secret, timeout=900)
    finally:
        for proc, _ in hosts:
            proc.terminate()
        for proc, _ in hosts:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return mnist, runs, cards


def test_engine_world_on_four_cards(engine_world):
    """The eager MNIST example at ``-np 4``, one rank per card: every
    rank's final parameters bitwise equal, step 1's averaged leaves bitwise
    ``_ring_order_reduce`` of the four local leaves, the loss falling; the
    engine worlds with ``init`` on each rank's card: every result the
    canonical oracle's (the grid order through the relays), 2 coordinator
    connections through the relays against 4; the engine's 64 MiB
    allreduce printed beside NCCL's."""
    import statistics

    import numpy as np
    import torch_port_engine_world_worker as W

    from horovod_tpu_torch.common.engine import _ring_order_reduce

    mnist, runs, cards = engine_world
    print(f"cards (name, power limit):\n{cards}")
    params = [k for k in mnist[0] if k.startswith("param.")]
    for k in params:
        assert all(m[k].tobytes() == mnist[0][k].tobytes() for m in mnist), k
    for k in [k for k in mnist[0] if k.startswith("avg.")]:
        n = k[4:]
        want = _ring_order_reduce([m["local." + n] for m in mnist], True)
        assert all(m[k].tobytes() == want.tobytes() for m in mnist), k
    losses = mnist[0]["losses"]
    print(f"eager MNIST on 4 cards: losses {losses.tolist()}")
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    oracle = W.oracle_digests(W.COMPS, W.STEPS, 4, W.sizes(W.ELEMS, W.SMALL),
                              grids=(None, (2, 2)))
    for label, grid, plane, conns in (("ring", None, "ring", 4),
                                      ("relayed hier", (2, 2), "hier", 2)):
        reports = runs[label]
        W.hold(reports, plane, oracle[grid])
        assert set(reports[0]["accepted"][plane].values()) == {conns}
        for comp, secs in reports[0]["engine_s"][plane].items():
            print(f"{label} {comp}: 64 MiB engine allreduce median "
                  f"{statistics.median(secs) * 1e3:.1f} ms of {len(secs)}; "
                  f"control bytes per exchange cold/cached "
                  f"{reports[0]['ctrl_bytes_per_exchange'][plane][comp]}")
        if "dist_s" in reports[0]:
            d = reports[0]["dist_s"]
            print(f"{d['backend']} allreduce of the same 64 MiB: median "
                  f"{statistics.median(d['big']) * 1e3:.2f} ms")
