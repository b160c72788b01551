"""The arithmetic of the bf16 tensor-core kernels of
``horovod_tpu_torch/csrc/flash_tc.cuh`` on the CPU, held to the JAX
package's Pallas kernels by the card's own rules: B1 (the forward), B2
(dQ) and B3 (dK/dV) against ``horovod_tpu.ops.flash_attention`` in bf16,
and B6 (one ring step's dK/dV into float32 carries) against
``horovod_tpu.ops.ring_flash``'s ``_rf_dkv_kernel``.

The kernels cannot run here, so a plain-torch emulation of what they
compute stands in for them: the same tiles in the same order (the
forward's k tiles of 128, dQ's k tiles of 64, dK/dV's blocks of 128 k rows
walking q tiles of 64), the online softmax and P = exp2(S * scale * log2e
- L * log2e) in log2 units, P (forward), dS (dQ), P^T and dS^T (dK/dV)
each split into a bf16 hi and a bf16 lo term for their products
(``_split``; the kernels' ``hopper::split_bf16``), everything else
float32, outputs rounded to bf16 or added into float32 carries. The dQ and
dK/dV emulations take L from the emulated forward and delta = rowsum(dO *
O) from the emulated bf16 O, as the training path does outside the
kernels. The flash reference is ``horovod_tpu.ops.flash_attention`` fed
the same bf16 inputs, in interpret mode under
``jax.default_matmul_precision("highest")``: float32 arithmetic, O, dQ, dK
and dV in bf16, and its delta from its bf16 O as well; its L is the
float64 logsumexp of the scaled logits. Inputs are made with numpy from a
seed. Rules, as ``chip_smoke.py`` holds the kernels on the card: O, dQ,
dK, dV element-wise |err| <= 2^-7 |ref| + 1e-2 x the rms of the
reference's row, and relative norm error <= 1e-2; L |err| <= 1e-4 x max(1,
max |L|). Negative cases drop one k tile from the forward and from dQ and
must fail the rule; another rounds the three operands to bf16 alone,
without the lo term, and breaks the rule on dK.

The ring references are the Pallas block kernels of one ring step, the
forward (B4), dQ (B5) and dK/dV (B6), in interpret mode on float32 arrays
that hold the same bf16 values (they compute in float32 whatever their
input type), with nonzero carries, L and delta, at a diagonal step, a past
step and a zigzag step where a q block or tile of the kernels straddles
the rank's two stripes; the rule is the float32 carries' own, |err| <=
1e-4 x max(1, max |ref|). B4 and B5 also take a fourth step from the
initial carries in which the rank's low stripe sees none of the block:
those rows must come back bit for bit (m -1e30, l 0, acc 0, and the dQ
carry as it was). Negative cases mask by index, as kFlash does, instead
of by positions, and (B4) mask to the finite sentinel without the pivot;
each fails the rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import ring_flash as jrf
from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import ring_flash as rf

TILE_K = 128          # forward k tile (flash_tc.cuh kFwdK)
DQ_TILE_K = 64        # dQ k tile (kDqK)
DKV_BLOCK_K, DKV_TILE_Q = 128, 64   # dK/dV k rows per block, q rows per tile
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
RING_BLOCK_Q = 128    # ring forward and dQ: q rows per block (kFwdQ, kDqQ)

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


def emulate_dq(qr, kr, vr, dor, lse, delta, h, hkv, causal, drop_tile=None,
               operand=_split):
    """B2's arithmetic: dQ in bf16, from k tiles of 64 in order."""
    rows, t, d = qr.shape
    kq, vq = fa._expand_kv(kr, h, hkv), fa._expand_kv(vr, h, hkv)
    scale = d ** -0.5
    live = _live(t, causal)
    dq = torch.zeros(rows, t, d)
    for k0 in range(0, t, DQ_TILE_K):
        if drop_tile == k0 // DQ_TILE_K:
            continue
        kt, vt = kq[:, k0:k0 + DQ_TILE_K], vq[:, k0:k0 + DQ_TILE_K]
        p = torch.exp2(qr @ kt.transpose(1, 2) * (scale * LOG2E)
                       - (lse * LOG2E)[..., None])
        p = p.masked_fill(~live[:, k0:k0 + DQ_TILE_K], 0.0)
        ds = p * (dor @ vt.transpose(1, 2) - delta[..., None])
        dq = dq + operand(ds) @ kt
    return _bf16(dq * scale)


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


def _emulate(q, k, v, g, causal, drop_tile=None, operand=_split, drop_dq_tile=None):
    """B1, B2 and B3 on (B, T, H, D) numpy arrays: O and L from the
    forward, then dQ, dK and dV from that L and the delta of its bf16 O."""
    b, t, h, _ = q.shape
    hkv = k.shape[2]
    qr, kr, vr, dor = (fa._rows(torch.from_numpy(x)) for x in (q, k, v, g))
    o, lse = emulate_fwd(qr, kr, vr, h, hkv, causal, drop_tile, operand)
    delta = (dor * o).sum(dim=-1)
    dq = emulate_dq(qr, kr, vr, dor, lse, delta, h, hkv, causal, drop_dq_tile, operand)
    dk, dv = emulate_dkv(qr, kr, vr, dor, lse, delta, h, hkv, causal, operand)
    return {"O": fa._unrows(o, b).numpy(), "L": lse.numpy(),
            "dQ": fa._unrows(dq, b).numpy(), "dK": fa._unrows(dk, b).numpy(),
            "dV": fa._unrows(dv, b).numpy()}


def _reference(q, k, v, g, causal):
    """The Pallas kernels fed bf16 (interpret mode, blocks of 64) and the
    float64 logsumexp of the scaled logits."""
    qb, kb, vb = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    with jax.default_matmul_precision("highest"):
        out = jax_flash(qb, kb, vb, causal, 64, 64)
        grads = jax.grad(lambda q, k, v: jnp.sum(
            jax_flash(q, k, v, causal, 64, 64).astype(jnp.float32) * g),
            argnums=(0, 1, 2))(qb, kb, vb)
    b, t, h, d = q.shape
    group = h // k.shape[2]
    q64 = q.astype(np.float64).transpose(0, 2, 1, 3)
    k64 = np.repeat(k.astype(np.float64), group, axis=2).transpose(0, 2, 1, 3)
    s = q64 @ k64.transpose(0, 1, 3, 2) * d ** -0.5
    s = np.where(_live(t, causal).numpy(), s, -np.inf)
    mx = s.max(axis=-1, keepdims=True)
    lse = (mx[..., 0] + np.log(np.exp(s - mx).sum(axis=-1))).reshape(b * h, t)
    f32 = [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]
    return {"O": f32[0], "L": lse, "dQ": f32[1], "dK": f32[2], "dV": f32[3]}


def within_rule(name, got, ref, noise_rows=()) -> tuple[bool, str]:
    """The card's rule for ``name``; (holds, description). ``noise_rows``:
    positions (axis 1) that are 0 in exact arithmetic, held to float32
    noise on both sides (|x| <= 1e-4) and left out of the relative rule."""
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    if noise_rows:
        noise = max(np.abs(got[:, noise_rows]).max(), np.abs(ref[:, noise_rows]).max())
        if not noise <= 1e-4:
            return False, f"rows {list(noise_rows)} read {noise:.3e}, not noise"
        keep = np.setdiff1d(np.arange(got.shape[1]), noise_rows)
        got, ref = got[:, keep], ref[:, keep]
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
    return _emulate(q, k, v, g, causal), _reference(q, k, v, g, causal), causal


def _noise_rows(name, causal):
    """Causal dQ's first row is 0 in exact arithmetic: one key, so dS =
    dP - delta = 0."""
    return [0] if causal and name == "dQ" else ()


@pytest.mark.parametrize("name", ["O", "L", "dQ", "dK", "dV"])
def test_emulation_within_the_card_rule(case, name):
    got, ref, causal = case
    assert got[name].shape == ref[name].shape
    ok, detail = within_rule(name, got[name], ref[name], _noise_rows(name, causal))
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


def test_dropped_dq_k_tile_fails_the_rule():
    """dQ's rule has teeth: B2's emulation without its first k tile of 64
    (keys 0-63, every row's first keys at T = 200) breaks it."""
    b, t, h, hkv, d, causal = 1, 200, 4, 2, 64, True
    q, k, v, g = _inputs(98, b, t, h, hkv, d)
    ref = _reference(q, k, v, g, causal)["dQ"]
    rows = _noise_rows("dQ", causal)
    assert within_rule("dQ", _emulate(q, k, v, g, causal)["dQ"], ref, rows)[0]
    bad = _emulate(q, k, v, g, causal, drop_dq_tile=0)["dQ"]
    assert not within_rule("dQ", bad, ref, rows)[0]


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


# ------------------------------------------------- B6: one ring step's dK/dV

RING_N = 4
RING_STEPS = {
    # name: (my rank, source rank of the K/V block, zigzag, T per rank)
    "diagonal": (1, 1, False, 128),
    "past": (2, 0, False, 128),       # every pair live
    # Stripes of 48 rows: the kernel's q tile [0, 64) holds the low stripe
    # (sees none of rank 2's block) and 16 rows of the high one (sees all).
    "zigzag_partial": (1, 2, True, 96),
}
RING_B, RING_H, RING_HKV = 1, 4, 2   # GQA: 4 q heads over 2 kv heads
RING_BLOCK = 32                      # the Pallas kernel's q and k blocks


def emulate_rf_dkv(qr, kr, vr, dor, lse, delta, qpos, kpos, dk, dv, h, hkv,
                   by_positions=True):
    """B6's arithmetic: (dk, dv) + this block's dK, dV, float32 carries.
    Blocks of 128 k rows walk (g, q tile of 64) over the GQA group; a pair
    with max(qpos) < min(kpos) is skipped, the rest masked by qpos >= kpos
    (or, ``by_positions=False``, by index as kFlash masks)."""
    rows, t, d = qr.shape
    rkv = kr.shape[0]
    scale = d ** -0.5
    group = h // hkv
    dk, dv = dk.clone(), dv.clone()
    for k0 in range(0, t, DKV_BLOCK_K):
        kp = kpos[k0:k0 + DKV_BLOCK_K]
        ks, vs = kr[:, k0:k0 + DKV_BLOCK_K], vr[:, k0:k0 + DKV_BLOCK_K]
        dka = torch.zeros(ks.shape)
        dva = torch.zeros(ks.shape)
        for g in range(group):
            rq = [(r // hkv) * h + (r % hkv) * group + g for r in range(rkv)]
            for q0 in range(0, t, DKV_TILE_Q):
                qp = qpos[q0:q0 + DKV_TILE_Q]
                if qp.max() < kp.min():
                    continue
                qt, dt = qr[rq, q0:q0 + DKV_TILE_Q], dor[rq, q0:q0 + DKV_TILE_Q]
                lt, et = lse[rq, q0:q0 + DKV_TILE_Q], delta[rq, q0:q0 + DKV_TILE_Q]
                pt = torch.exp2(ks @ qt.transpose(1, 2) * (scale * LOG2E)
                                - (lt * LOG2E)[:, None, :])      # (rkv, k, q)
                if by_positions:
                    live = qp[None, :] >= kp[:, None]
                else:
                    live = (torch.arange(q0, q0 + len(qp))[None, :]
                            >= torch.arange(k0, k0 + len(kp))[:, None])
                pt = torch.where(live, pt, torch.zeros(()))
                dst = pt * (vs @ dt.transpose(1, 2) - et[:, None, :])
                dva = dva + _split(pt) @ dt
                dka = dka + _split(dst) @ qt
        dk[:, k0:k0 + DKV_BLOCK_K] += dka * scale
        dv[:, k0:k0 + DKV_BLOCK_K] += dva
    return dk, dv


def _ring_inputs(seed, t, d, my, src, zigzag):
    rng = np.random.default_rng(seed)
    r, rkv = RING_B * RING_H, RING_B * RING_HKV

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    x = {"q": normal(r, t, d), "k": normal(rkv, t, d), "v": normal(rkv, t, d),
         "do": normal(r, t, d)}
    x = {n: _bf16(torch.from_numpy(a)).numpy() for n, a in x.items()}   # bf16 values
    x.update(lse=rng.uniform(1.0, 3.0, (r, t)).astype(np.float32),
             delta=normal(r, t), dk=normal(rkv, t, d), dv=normal(rkv, t, d),
             qpos=np.array(jrf._positions(my, t, RING_N, zigzag), np.int32),
             kpos=np.array(jrf._positions(src, t, RING_N, zigzag), np.int32))
    return x


def _ring_reference(x, t):
    """The Pallas dK/dV block kernel, interpret mode, float32 arithmetic."""
    j = {n: jnp.asarray(a) for n, a in x.items()}

    def rows8(a):
        return jnp.broadcast_to(a[:, None, :], (a.shape[0], 8, a.shape[1]))

    with jax.default_matmul_precision("highest"):
        dk, dv = jrf._dkv_block_call(
            j["q"], j["k"], j["v"], j["do"], rows8(j["lse"]), rows8(j["delta"]),
            jrf._qpos_arr(j["qpos"], t), jrf._kpos_arr(j["kpos"], t), j["dk"],
            j["dv"], RING_BLOCK, RING_BLOCK, RING_H, RING_HKV,
            RING_H // RING_HKV, True)
    return np.asarray(dk), np.asarray(dv)


def _ring_emulate(x, by_positions=True):
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    dk, dv = emulate_rf_dkv(t["q"], t["k"], t["v"], t["do"], t["lse"], t["delta"],
                            t["qpos"], t["kpos"], t["dk"], t["dv"], RING_H,
                            RING_HKV, by_positions)
    return dk.numpy(), dv.numpy()


def _carry_ok(got, ref) -> tuple[bool, float]:
    """The float32 carries' rule; (holds, err / limit)."""
    limit = 1e-4 * max(1.0, float(np.abs(ref).max()))
    worst = float(np.abs(got.astype(np.float64) - ref).max()) / limit
    return worst <= 1.0, worst


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("step", sorted(RING_STEPS))
def test_ring_dkv_emulation_within_the_carry_rule(step, d):
    my, src, zigzag, t = RING_STEPS[step]
    x = _ring_inputs(sorted(RING_STEPS).index(step) * 10 + d, t, d, my, src, zigzag)
    want = _ring_reference(x, t)
    got = _ring_emulate(x)
    for name, g, w in zip(("dK", "dV"), got, want):
        assert g.shape == w.shape
        ok, worst = _carry_ok(g, w)
        assert ok, f"{step} d={d} {name}: {worst:.3f} of the limit"


def test_ring_dkv_masked_by_index_fails_the_rule():
    """The positions matter: at the zigzag step, masking by index (as the
    kFlash kernel does) instead of by positions breaks the rule."""
    my, src, zigzag, t = RING_STEPS["zigzag_partial"]
    x = _ring_inputs(7, t, 64, my, src, zigzag)
    want = _ring_reference(x, t)
    assert all(_carry_ok(g, w)[0] for g, w in zip(_ring_emulate(x), want))
    bad = _ring_emulate(x, by_positions=False)
    assert not all(_carry_ok(g, w)[0] for g, w in zip(bad, want))


# ------------------------------------------ B4 and B5: one ring step's forward and dQ

# The three RING_STEPS, and a fourth from the initial carries: rank 0's low
# stripe (positions 0-47) sees none of rank 1's block (48-95, 288-335).
RF_STEPS = {**RING_STEPS, "no_live_key": (0, 1, True, 96)}
MASKED_LOG2 = NEG_INF * LOG2E   # the sentinel, in the kernel's log2 units


def _ring_live(qp, kp, q0, k0, by_positions):
    if by_positions:
        return qp[:, None] >= kp[None, :]
    return torch.arange(q0, q0 + len(qp))[:, None] >= torch.arange(k0, k0 + len(kp))[None, :]


def emulate_rf_fwd(qr, kr, vr, acc, m, l, qpos, kpos, h, hkv, by_positions=True,
                   masked=-np.inf, pivot=True):
    """B4's arithmetic: the carries (acc, m, l) after one ring step, in
    float32. Blocks of 128 q rows walk k tiles of 128; a tile whose
    min(kpos) is past the block's max(qpos) is skipped, the rest masked by
    qpos >= kpos (or, ``by_positions=False``, by index). m runs in log2
    units of the scaled logits: the carry is converted on entry and back
    on exit, where a row whose max did not move keeps its carry's bits. A
    masked scaled logit reads ``masked`` (the kernel's -inf, or the
    sentinel), a row whose max is still the sentinel pivots on 0
    (``pivot``), and P enters P.V split into bf16 hi + lo."""
    rows, t, d = qr.shape
    kq, vq = fa._expand_kv(kr, h, hkv), fa._expand_kv(vr, h, hkv)
    scale_log2 = LOG2E / d ** 0.5
    acc, l = acc.clone(), l.clone()
    m2 = m * LOG2E
    for q0 in range(0, t, RING_BLOCK_Q):
        rs = slice(q0, q0 + RING_BLOCK_Q)
        qp = qpos[rs]
        for k0 in range(0, t, TILE_K):
            kp = kpos[k0:k0 + TILE_K]
            if kp.min() > qp.max():
                continue
            s = qr[:, rs] @ kq[:, k0:k0 + TILE_K].transpose(1, 2) * scale_log2
            s = s.masked_fill(~_ring_live(qp, kp, q0, k0, by_positions), masked)
            m_new = torch.maximum(m2[:, rs], s.max(dim=-1).values)
            piv = torch.where(m_new <= NEG_INF * 0.5, 0.0, m_new) if pivot else m_new
            alpha = torch.exp2(m2[:, rs] - piv)
            p = torch.exp2(s - piv[..., None])
            l[:, rs] = l[:, rs] * alpha + p.sum(dim=-1)
            acc[:, rs] = acc[:, rs] * alpha[..., None] + _split(p) @ vq[:, k0:k0 + TILE_K]
            m2[:, rs] = m_new
    return acc, torch.where(m2 == m * LOG2E, m, m2 * LN2), l


def emulate_rf_dq(qr, kr, vr, dor, lse, delta, qpos, kpos, dq, h, hkv,
                  by_positions=True):
    """B5's arithmetic: dq + this block's dQ, float32 carry. Blocks of 128
    q rows walk k tiles of 64, skipped and masked as B4's; P is set to 0
    where masked and dS enters dS.K split into bf16 hi + lo."""
    rows, t, d = qr.shape
    kq, vq = fa._expand_kv(kr, h, hkv), fa._expand_kv(vr, h, hkv)
    scale = d ** -0.5
    dq = dq.clone()
    for q0 in range(0, t, RING_BLOCK_Q):
        rs = slice(q0, q0 + RING_BLOCK_Q)
        qp = qpos[rs]
        dqa = torch.zeros(rows, len(qp), d)
        for k0 in range(0, t, DQ_TILE_K):
            kp = kpos[k0:k0 + DQ_TILE_K]
            if kp.min() > qp.max():
                continue
            kt, vt = kq[:, k0:k0 + DQ_TILE_K], vq[:, k0:k0 + DQ_TILE_K]
            p = torch.exp2(qr[:, rs] @ kt.transpose(1, 2) * (scale * LOG2E)
                           - (lse[:, rs] * LOG2E)[..., None])
            p = torch.where(_ring_live(qp, kp, q0, k0, by_positions), p, torch.zeros(()))
            ds = p * (dor[:, rs] @ vt.transpose(1, 2) - delta[:, rs][..., None])
            dqa = dqa + _split(ds) @ kt
        dq[:, rs] += dqa * scale
    return dq


def _rf_inputs(step, d):
    """_ring_inputs at ``step``, with forward carries (the initial ones at
    no_live_key) and a dQ carry."""
    my, src, zigzag, t = RF_STEPS[step]
    seed = sorted(RF_STEPS).index(step) * 10 + d
    x = _ring_inputs(seed, t, d, my, src, zigzag)
    rng = np.random.default_rng(seed + 1000)
    r = RING_B * RING_H
    if step == "no_live_key":
        x.update(acc=np.zeros((r, t, d), np.float32), m=np.full((r, t), NEG_INF, np.float32),
                 l=np.zeros((r, t), np.float32))
    else:
        x.update(acc=rng.standard_normal((r, t, d), dtype=np.float32),
                 m=rng.standard_normal((r, t), dtype=np.float32),
                 l=rng.uniform(0.5, 1.5, (r, t)).astype(np.float32))
    x["dq"] = rng.standard_normal((r, t, d), dtype=np.float32)
    return x, t


def _rf_reference(x, t):
    """The Pallas forward and dQ block kernels, interpret mode, float32
    arithmetic: ((acc, m, l), dq)."""
    j = {n: jnp.asarray(a) for n, a in x.items()}

    def rows8(a):
        return jnp.broadcast_to(a[:, None, :], (a.shape[0], 8, a.shape[1]))

    qp, kp = jrf._qpos_arr(j["qpos"], t), jrf._kpos_arr(j["kpos"], t)
    group = RING_H // RING_HKV
    with jax.default_matmul_precision("highest"):
        acc, m, l = jrf._fwd_block_call(
            j["q"], j["k"], j["v"], j["acc"], rows8(j["m"]), rows8(j["l"]), qp, kp,
            RING_BLOCK, RING_BLOCK, RING_H, RING_HKV, group, True)
        dq = jrf._dq_block_call(
            j["q"], j["k"], j["v"], j["do"], rows8(j["lse"]), rows8(j["delta"]), qp, kp,
            j["dq"], RING_BLOCK, RING_BLOCK, RING_H, RING_HKV, group, True)
    return (np.asarray(acc), np.asarray(m)[:, 0], np.asarray(l)[:, 0]), np.asarray(dq)


def _rf_emulate(x, by_positions=True, masked=-np.inf, pivot=True):
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    carries = emulate_rf_fwd(t["q"], t["k"], t["v"], t["acc"], t["m"], t["l"], t["qpos"],
                             t["kpos"], RING_H, RING_HKV, by_positions, masked, pivot)
    dq = emulate_rf_dq(t["q"], t["k"], t["v"], t["do"], t["lse"], t["delta"], t["qpos"],
                       t["kpos"], t["dq"], RING_H, RING_HKV, by_positions)
    return tuple(c.numpy() for c in carries), dq.numpy()


def _no_live_key_rows(x):
    return ~(x["qpos"][:, None] >= x["kpos"][None, :]).any(axis=1)


def _rf_hold(x, got, want):
    """Each carry against the reference: rows with no live key keep the
    carry they came with bit for bit on both sides, the other rows are held
    by the carry rule. Returns the names that break it."""
    dead = _no_live_key_rows(x)
    (acc, m, l), dq = got
    (acc_r, m_r, l_r), dq_r = want
    bad = []
    for name, g, w in (("acc", acc, acc_r), ("m", m, m_r), ("l", l, l_r), ("dQ", dq, dq_r)):
        assert g.shape == w.shape, name
        if dead.any():
            before = x[name.lower()][:, dead]
            assert np.array_equal(w[:, dead], before), f"reference {name}"
            if not np.array_equal(g[:, dead], before):
                bad.append(name)
                continue
        if not _carry_ok(g[:, ~dead], w[:, ~dead])[0]:
            bad.append(name)
    return bad


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("step", sorted(RF_STEPS))
def test_ring_fwd_and_dq_emulation_within_the_carry_rule(step, d):
    """B4's (acc, m, l) and B5's dQ carry against the Pallas kernels; at
    the zigzag steps, the rows that see none of the block come back bit
    for bit (from the initial carries at no_live_key)."""
    x, t = _rf_inputs(step, d)
    assert _no_live_key_rows(x).any() == RF_STEPS[step][2]
    bad = _rf_hold(x, _rf_emulate(x), _rf_reference(x, t))
    assert not bad, f"{step} d={d}: {bad} break the rule"


def test_ring_fwd_and_dq_masked_by_index_fail_the_rule():
    """The positions matter for B4 and B5 too: at the zigzag step, masking
    by index instead of by positions breaks the rule on every carry."""
    x, t = _rf_inputs("zigzag_partial", 64)
    want = _rf_reference(x, t)
    assert not _rf_hold(x, _rf_emulate(x), want)
    assert set(_rf_hold(x, _rf_emulate(x, by_positions=False), want)) == {"acc", "m", "l", "dQ"}


def test_ring_fwd_sentinel_mask_without_the_pivot_fails_the_rule():
    """Why the pivot: a port that masks a scaled logit to the finite
    sentinel (as the Pallas kernel masks to -1e30), as a row with no live
    key yet also carries m, needs m_safe. With it the rows that see none
    of the block come back bit for bit; without it their p = exp2(0) = 1,
    so l counts the masked keys and acc sums their values. The kernel masks
    to -inf, where those p are 0 either way."""
    x, t = _rf_inputs("no_live_key", 64)
    want = _rf_reference(x, t)
    assert not _rf_hold(x, _rf_emulate(x, masked=MASKED_LOG2), want)
    bad = _rf_hold(x, _rf_emulate(x, masked=MASKED_LOG2, pivot=False), want)
    assert {"acc", "l"} <= set(bad)
