"""The port's flash attention on the CPU against the JAX package's Pallas
kernels in interpret mode: forward and all three gradients, causal and
not, GQA, a ragged sequence length, and the head-count errors.

On the CPU ``horovod_tpu_torch.ops.flash_attention`` runs the plain
versions of its three kernels (the same float32 arithmetic); the CUDA
kernels themselves are held against those plain versions on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``). Tolerances are the
JAX suite's own for its kernels against the dense oracle: atol/rtol 2e-6
forward, 5e-6 gradients, at float32 under highest matmul precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as fa

FWD_TOL = 2e-6
GRAD_TOL = 5e-6


def _inputs(seed, b, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d), dtype=np.float32)
    k = rng.standard_normal((b, t, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, t, hkv, d), dtype=np.float32)
    g = rng.standard_normal((b, t, h, d), dtype=np.float32)
    return q, k, v, g


def _jax(q, k, v, g, causal, block_q, block_k):
    with jax.default_matmul_precision("highest"):
        out = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                        block_q, block_k)
        grads = jax.grad(lambda q, k, v: jnp.sum(
            jax_flash(q, k, v, causal, block_q, block_k) * g),
            argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _torch(fn, q, k, v, g, causal):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(qt, kt, vt, causal)
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


CASES = {
    # name: (b, t, h, hkv, d, causal, jax block_q, jax block_k)
    "causal": (2, 128, 2, 2, 32, True, 32, 32),
    "non_causal": (2, 128, 2, 2, 32, False, 32, 32),
    "gqa_4_over_2": (2, 64, 4, 2, 32, True, 16, 8),
    "ragged_t96": (2, 96, 2, 2, 32, True, 64, 64),
    "ragged_t96_non_causal_gqa": (1, 96, 4, 2, 16, False, 64, 64),
}


@pytest.mark.parametrize("fn_name", ["flash_attention", "flash_attention_reference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_pallas(case, fn_name):
    b, t, h, hkv, d, causal, bq, bk = CASES[case]
    q, k, v, g = _inputs(sorted(CASES).index(case), b, t, h, hkv, d)
    ref_out, ref_grads = _jax(q, k, v, g, causal, bq, bk)
    out, grads = _torch(getattr(fa, fn_name), q, k, v, g, causal)
    np.testing.assert_allclose(out, ref_out, atol=FWD_TOL, rtol=FWD_TOL)
    for got, want, name in zip(grads, ref_grads, "qkv"):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_plain_kernels_match_reference_autograd(causal):
    """Each kernel's plain version, in the rows layout, against autograd
    through the dense reference: L, delta and the GQA fold are right."""
    q, k, v, g = _inputs(11, 2, 96, 4, 2, 32)
    h, hkv = 4, 2
    qt, kt, vt, gt = (torch.tensor(x) for x in (q, k, v, g))
    qr, kr, vr, dor = fa._rows(qt), fa._rows(kt), fa._rows(vt), fa._rows(gt)
    out, lse = fa.fwd_plain(qr, kr, vr, h, hkv, causal)
    delta = (dor * out).sum(-1)
    dq = fa.dq_plain(qr, kr, vr, dor, lse, delta, h, hkv, causal)
    dk, dv = fa.dkv_plain(qr, kr, vr, dor, lse, delta, h, hkv, causal)
    ref_out, ref_grads = _torch(fa.flash_attention_reference, q, k, v, g, causal)
    np.testing.assert_allclose(fa._unrows(out, 2).numpy(), ref_out,
                               atol=FWD_TOL, rtol=FWD_TOL)
    for got, want in zip((dq, dk, dv), ref_grads):
        np.testing.assert_allclose(fa._unrows(got, 2).numpy(), want,
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_lse_matches_logsumexp():
    q, k, v, _ = _inputs(3, 1, 96, 2, 2, 32)
    qr, kr, vr = (fa._rows(torch.tensor(x)) for x in (q, k, v))
    _, lse = fa.fwd_plain(qr, kr, vr, 2, 2, True)
    s = qr @ kr.transpose(1, 2) * 32 ** -0.5
    s = s.masked_fill(~torch.ones(96, 96, dtype=torch.bool).tril(), float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=1e-5, rtol=1e-6)
    assert lse.shape == (2, 96) and lse.dtype == torch.float32


def test_rejects_bad_heads():
    q, k, v, _ = _inputs(0, 2, 32, 2, 1, 32)
    k3 = torch.tensor(np.repeat(k, 3, axis=2))
    v3 = torch.tensor(np.repeat(v, 3, axis=2))
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(torch.tensor(q), k3, v3)
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention_reference(torch.tensor(q), k3, v3)
    with pytest.raises(ValueError, match="k has 3 heads but v has 1"):
        fa.flash_attention(torch.tensor(q), k3, torch.tensor(v))


def test_cpu_path_launches_no_kernel():
    fa.reset_launches()
    q, k, v, g = _inputs(1, 1, 64, 2, 2, 32)
    _torch(fa.flash_attention, q, k, v, g, True)
    assert fa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_bf16_cpu_outputs_keep_input_dtype():
    q, k, v, g = _inputs(2, 1, 64, 2, 2, 32)
    qt, kt, vt = (torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
                  for x in (q, k, v))
    out = fa.flash_attention(qt, kt, vt)
    (out.float() * torch.tensor(g)).sum().backward()
    assert out.dtype == qt.grad.dtype == kt.grad.dtype == vt.grad.dtype == torch.bfloat16
