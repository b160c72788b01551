"""The CUDA flash kernels against their plain versions, on the card.

Needs an NVIDIA Hopper GPU and nvcc; elsewhere every test skips. Run on
the card with (conftest.py imports jax, which the GPU machine need not
have)::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances, in float32: float32 outputs agree to 1e-4 times the largest
reference magnitude (or 1e-4, whichever is larger), the same sums in
another order. bf16 outputs, held against the plain version fed the same
bf16 inputs, may differ by one unit in the last place: |err| <= 2^-7 |ref|
+ 1e-2 times the rms of the reference's row (its last dim), and the
relative norm error is at most 1e-2.
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa

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


def _check(cuda, b, t, h, hkv, d, causal, dtype, seed=0):
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
        _assert_close(name, got[name], want[name])


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, d, dtype):
    _check(cuda, 2, 256, 4, 4, d, True, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_ragged(cuda, causal):
    _check(cuda, 2, 96, 8, 2, 64, causal, torch.float32, seed=1)
    _check(cuda, 1, 200, 4, 1, 128, causal, torch.bfloat16, seed=2)


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
