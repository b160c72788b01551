"""The CUDA kernels against their plain versions, on the card: the flash
kernels (B1-B3) and the ring-flash kernels (B4-B6); and the
sequence-parallel training step over NCCL on every visible GPU.

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
1e-2. The NCCL world holds the sp step to slice 1's flash step on the whole
sequence: loss 1e-3 relative, every gradient 3e-2 relative norm error
(bf16 activations summed in another order across the ring).
"""

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


def _assert_close(name, got, want):
    assert got.dtype == want.dtype, name
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.float32:
        assert err.max().item() <= 1e-4 * max(1.0, w.abs().max().item()), name
        return
    row_rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    assert bool((err <= 2.0 ** -7 * w.abs() + 1e-2 * row_rms).all()), \
        (name, err.max().item())
    assert (g - w).norm().item() <= 1e-2 * w.norm().item(), name


def _check(cuda, b, t, h, hkv, d, causal, dtype, seed=0, zero=()):
    """The kernels against their plain versions; outputs named in ``zero``
    are 0 in exact arithmetic, and both sides must come out as float32
    noise (|x| <= 1e-4), which no relative rule can compare."""
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
    got["o"], got["lse"] = fa.flash_fwd(qr, kr, vr, h, hkv, causal)
    got["dq"] = fa.flash_bwd_dq(qr, kr, vr, dor, lse_p, delta, h, hkv, causal)
    got["dk"], got["dv"] = fa.flash_bwd_dkv(qr, kr, vr, dor, lse_p, delta, h, hkv, causal)
    torch.cuda.synchronize()
    for name in want:
        if name in zero:
            assert got[name].abs().max().item() <= 1e-4, name
            assert want[name].abs().max().item() <= 1e-4, name
        else:
            _assert_close(name, got[name], want[name])


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


def test_bf16_tensor_core_kernels_reject_unaligned_inputs(cuda):
    """TMA needs 16-byte aligned bases: a bf16 tensor whose storage
    offset breaks that raises, and nothing launches."""
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
    assert fa.launches["flash_fwd"] == fa.launches["flash_bwd_dkv"] == 0


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

def _ring_check(cuda, b, t, h, hkv, d, dtype, my, src, zigzag, n=4, seed=0):
    """One ring step's three kernels against their plain versions on the
    same inputs and the same nonzero carries; returns the carries before."""
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
    for c, fwd, dq, dkv in ((got, rf.rf_fwd, rf.rf_bwd_dq, rf.rf_bwd_dkv),
                            (want, rf.rf_fwd_plain, rf.rf_dq_plain, rf.rf_dkv_plain)):
        fwd(qr, kr, vr, c["acc"], c["m"], c["l"], qpos, kpos, h, hkv)
        dq(qr, kr, vr, dor, lse, delta, qpos, kpos, c["dq"], h, hkv)
        dkv(qr, kr, vr, dor, lse, delta, qpos, kpos, c["dk"], c["dv"], h, hkv)
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


def test_ring_step_with_every_tile_skipped_keeps_the_carries(cuda):
    """Contiguous rank 0 against rank 3's block: every pair masked, so
    every tile pair is skipped inside the kernels and no carry moves."""
    assert ra.fully_masked(0, 3, 160, 4, False)
    before, got = _ring_check(cuda, 1, 160, 4, 2, 64, torch.float32, my=0,
                              src=3, zigzag=False)
    for name in before:
        assert torch.equal(got[name], before[name]), name


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

@pytest.fixture(scope="module")
def sp_world():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    n = torch.cuda.device_count()
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", RING_DEVICE="cuda")
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
            env.pop(var, None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_port_ring_worker.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures, outs = [], []
    for rank, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failures.append(f"rank {rank} exit {proc.returncode}:\n{err[-3000:]}")
    assert not failures, "\n".join(failures)
    return n, outs[0]


def test_sp_world_step_matches_whole_sequence_step(sp_world):
    n, out = sp_world
    print(out)
    assert f"ok sp world {n}" in out
