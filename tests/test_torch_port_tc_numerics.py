"""The arithmetic of the bf16 tensor-core kernels (B1, the forward, and
B3, dK/dV, in ``horovod_tpu_torch/csrc/flash_tc.cuh``) on the CPU, held to
the JAX package's Pallas kernels in bf16 by the card's own rules.

The kernels cannot run here, so a plain-torch emulation of what they
compute stands in for them: the same k tiles of 128 in the same order, the
online softmax in log2 units, P (forward), P^T and dS^T (dK/dV) each split
into a bf16 hi and a bf16 lo term for their products (``_split``; the
kernels' ``hopper::split_bf16``), everything else float32, outputs rounded
to bf16. The dK/dV emulation takes L from the emulated forward and delta =
rowsum(dO * O) from the emulated bf16 O, as the training path does outside
the kernels. The reference is ``horovod_tpu.ops.flash_attention`` fed the
same bf16 inputs, in interpret mode under
``jax.default_matmul_precision("highest")``: float32 arithmetic, O, dK
and dV in bf16, and its delta from its bf16 O as well; its L is the
float64 logsumexp of the scaled logits. Inputs are made with numpy from a
seed. Rules, as ``chip_smoke.py`` holds the kernels on the card: O, dK, dV
element-wise |err| <= 2^-7 |ref| + 1e-2 x the rms of the reference's row,
and relative norm error <= 1e-2; L |err| <= 1e-4 x max(1, max |L|). A
negative case drops one k tile from the emulation and must fail the rule;
another rounds the three operands to bf16 alone, without the lo term, and
breaks the rule on dK.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as fa

TILE_K = 128          # forward k tile (flash_tc.cuh kFwdK)
LOG2E = 1.4426950408889634
NEG_INF = -1e30

SHAPES = [
    # (b, t, h, hkv, d, causal): T = 96 and 200 are ragged against the
    # kernels' 128-row tiles; 4 q heads over 2 kv heads is GQA.
    (1, 96, 2, 2, 32, True),
    (1, 96, 4, 2, 32, False),
    (1, 200, 4, 2, 64, True),
    (1, 200, 2, 2, 64, False),
    (1, 256, 2, 2, 128, True),
    (1, 200, 4, 2, 128, False),
    (1, 96, 4, 2, 128, True),
    (1, 256, 4, 2, 64, False),
]
# A shape and seed at which P^T and dS^T rounded to bf16 alone break the
# dK rule (they read 1.58 of the limit; the split reads 0.57).
SHAPE_ROUNDING, SEED_ROUNDING = (2, 200, 4, 4, 128, True), 3


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels feed it to a product: bf16 hi plus bf16 lo."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _inputs(seed, b, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    shapes = ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, t, h, d))
    return [_bf16(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))).numpy()
            for s in shapes]


def _live(t: int, causal: bool) -> torch.Tensor:
    pos = torch.arange(t)
    return pos[:, None] >= pos[None, :] if causal else torch.ones(t, t, dtype=torch.bool)


def emulate_fwd(qr, kr, vr, h, hkv, causal, drop_tile=None, operand=_split):
    """B1's arithmetic on rows-layout float32 tensors: (O in bf16, L)."""
    rows, t, d = qr.shape
    kq, vq = fa._expand_kv(kr, h, hkv), fa._expand_kv(vr, h, hkv)
    scale_log2 = LOG2E / d ** 0.5
    m = torch.full((rows, t), NEG_INF)
    l = torch.zeros(rows, t)
    acc = torch.zeros(rows, t, d)
    live = _live(t, causal)
    for k0 in range(0, t, TILE_K):
        if drop_tile == k0 // TILE_K:
            continue
        s = qr @ kq[:, k0:k0 + TILE_K].transpose(1, 2)
        s = s.masked_fill(~live[:, k0:k0 + TILE_K], NEG_INF)
        m_new = torch.maximum(m, s.max(dim=-1).values * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + operand(p) @ vq[:, k0:k0 + TILE_K]
        m = m_new
    return _bf16(acc / l[..., None]), m * np.log(2.0) + torch.log(l)


def emulate_dkv(qr, kr, vr, dor, lse, delta, h, hkv, causal, operand=_split):
    """B3's arithmetic: (dK, dV) in bf16, each summed over its group."""
    rows, t, d = qr.shape
    kq, vq = fa._expand_kv(kr, h, hkv), fa._expand_kv(vr, h, hkv)
    scale = d ** -0.5
    pt = torch.exp2(kq @ qr.transpose(1, 2) * (scale * LOG2E)
                    - (lse * LOG2E)[:, None, :])                 # (rows, k, q)
    pt = pt.masked_fill(~_live(t, causal).T, 0.0)
    dst = pt * (vq @ dor.transpose(1, 2) - delta[:, None, :])
    dv = operand(pt) @ dor
    dk = operand(dst) @ qr * scale
    rkv = kr.shape[0]

    def fold(x):
        return x.view(rkv // hkv, hkv, h // hkv, t, d).sum(dim=2).reshape(rkv, t, d)

    return _bf16(fold(dk)), _bf16(fold(dv))


def _emulate(q, k, v, g, causal, drop_tile=None, operand=_split):
    """B1 and B3 on (B, T, H, D) numpy arrays: O and L from the forward,
    then dK and dV from that L and the delta of its bf16 O."""
    b, t, h, _ = q.shape
    hkv = k.shape[2]
    qr, kr, vr, dor = (fa._rows(torch.from_numpy(x)) for x in (q, k, v, g))
    o, lse = emulate_fwd(qr, kr, vr, h, hkv, causal, drop_tile, operand)
    delta = (dor * o).sum(dim=-1)
    dk, dv = emulate_dkv(qr, kr, vr, dor, lse, delta, h, hkv, causal, operand)
    return {"O": fa._unrows(o, b).numpy(), "L": lse.numpy(),
            "dK": fa._unrows(dk, b).numpy(), "dV": fa._unrows(dv, b).numpy()}


def _reference(q, k, v, g, causal):
    """The Pallas kernels fed bf16 (interpret mode, blocks of 64) and the
    float64 logsumexp of the scaled logits."""
    qb, kb, vb = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    with jax.default_matmul_precision("highest"):
        out = jax_flash(qb, kb, vb, causal, 64, 64)
        grads = jax.grad(lambda q, k, v: jnp.sum(
            jax_flash(q, k, v, causal, 64, 64).astype(jnp.float32) * g),
            argnums=(1, 2))(qb, kb, vb)
    b, t, h, d = q.shape
    group = h // k.shape[2]
    q64 = q.astype(np.float64).transpose(0, 2, 1, 3)
    k64 = np.repeat(k.astype(np.float64), group, axis=2).transpose(0, 2, 1, 3)
    s = q64 @ k64.transpose(0, 1, 3, 2) * d ** -0.5
    s = np.where(_live(t, causal).numpy(), s, -np.inf)
    mx = s.max(axis=-1, keepdims=True)
    lse = (mx[..., 0] + np.log(np.exp(s - mx).sum(axis=-1))).reshape(b * h, t)
    f32 = [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]
    return {"O": f32[0], "L": lse, "dK": f32[1], "dV": f32[2]}


def within_rule(name, got, ref) -> tuple[bool, str]:
    """The card's rule for ``name``; (holds, description)."""
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    err = np.abs(got - ref)
    if name == "L":
        limit = 1e-4 * max(1.0, np.abs(ref).max())
        return bool(err.max() <= limit), f"max err {err.max():.3e} limit {limit:.3e}"
    rms = np.sqrt((ref ** 2).mean(axis=-1, keepdims=True))
    worst = (err / (2.0 ** -7 * np.abs(ref) + 1e-2 * rms)).max()
    relnorm = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    ok = bool(worst <= 1.0 and relnorm <= 1e-2)
    return ok, f"worst/limit {worst:.3f}, relnorm {relnorm:.3e}"


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "b{}_t{}_h{}over{}_d{}_{}".format(
    *s[:5], "causal" if s[5] else "full"))
def case(request):
    b, t, h, hkv, d, causal = request.param
    q, k, v, g = _inputs(SHAPES.index(request.param), b, t, h, hkv, d)
    return _emulate(q, k, v, g, causal), _reference(q, k, v, g, causal)


@pytest.mark.parametrize("name", ["O", "L", "dK", "dV"])
def test_emulation_within_the_card_rule(case, name):
    got, ref = case
    assert got[name].shape == ref[name].shape
    ok, detail = within_rule(name, got[name], ref[name])
    assert ok, f"{name}: {detail}"


def test_dropped_k_tile_fails_the_rule():
    """The rule has teeth: the emulation without its first k tile (keys
    0-127, every query's pivot at T = 200) breaks it."""
    b, t, h, hkv, d, causal = 1, 200, 4, 2, 64, True
    q, k, v, g = _inputs(99, b, t, h, hkv, d)
    ref_o = _reference(q, k, v, g, causal)["O"]
    good = _emulate(q, k, v, g, causal)
    assert within_rule("O", good["O"], ref_o)[0]
    # Tile 1 alone: rows 0-127 see no key and come out NaN (0 / 0), which
    # fails any comparison; rows 128-199 lose most of their keys.
    bad = _emulate(q, k, v, g, causal, drop_tile=0)["O"]
    assert not within_rule("O", bad, ref_o)[0]
    assert not within_rule("O", np.nan_to_num(bad), ref_o)[0]


def test_bf16_operands_alone_fail_the_rule():
    """Why the kernels split P, P^T and dS^T: rounded to bf16 alone, each
    term of a product errs by up to 2^-8, and in a row of dK where a few
    large terms cancel that exceeds 1e-2 of the row's rms."""
    b, t, h, hkv, d, causal = SHAPE_ROUNDING
    q, k, v, g = _inputs(SEED_ROUNDING, b, t, h, hkv, d)
    ref = _reference(q, k, v, g, causal)
    assert within_rule("dK", _emulate(q, k, v, g, causal)["dK"], ref["dK"])[0]
    rounded = _emulate(q, k, v, g, causal, operand=_bf16)["dK"]
    assert not within_rule("dK", rounded, ref["dK"])[0]
