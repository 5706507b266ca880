"""The port's attention kernels' plain versions (the CPU path of their
wrappers) against the reference: the Pallas kernels in interpret mode and
the ``kernels/ref.py`` oracles, over the reference kernel tests' shapes
plus grouped-query (GQA) cases, in f32 (2e-6) and bf16 (2e-2), the
reference kernel tests' tolerances.  Then the wrappers' dispatch, argument
checks and launch counters.  Then what the card computes, emulated here
in plain torch and held to the same references: the tensor-core flash
kernel's arithmetic (64-key tiles, P rounded to bf16 before P V) and the
split-then-combine decode at a split's edges and pos -1; and the
wrappers' pure choices (flash variant, decode split count).  The CUDA
kernels themselves are held to their plain versions on a card by
``test_torch_attention_card.py``."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.kernels import ref as RREF
from repro.kernels.decode_attention import decode_attention_bhd as pallas_decode
from repro.kernels.flash_attention import flash_attention_bhsd as pallas_flash
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

#: the reference kernel tests' shapes: (BH, S, hd, blk_q, blk_k)
ATTN_SHAPES = [
    (2, 64, 32, 32, 32),
    (4, 128, 64, 64, 32),
    (1, 256, 16, 64, 64),
    (3, 128, 128, 128, 128),
]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x: np.ndarray, jdt, tdt):
    """The same values as a JAX array and a torch tensor of the dtype."""
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(got: torch.Tensor, want, tdt):
    tol = TOL[tdt]
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _x32():
    """JAX's default 32-bit mode for every call into the reference."""
    return jax.enable_x64(False)


# --------------------------------------------------------------------------- #
# flash_attention_bhsd
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bh,s,hd,bq,bk", ATTN_SHAPES)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_oracle(bh, s, hd, bq, bk, jdt, tdt, causal):
    rng = np.random.default_rng(1000 * bh + s + hd)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(_normal(rng, (bh, s, hd)), jdt, tdt)
                                    for _ in range(3))
    got = FA.flash_attention_bhsd(qt, kt, vt, causal=causal)
    with _x32():
        kern = pallas_flash(qj, kj, vj, causal=causal, blk_q=bq, blk_k=bk, interpret=True)
        oracle = RREF.flash_attention_ref(qj, kj, vj, causal=causal)
    _close(got, kern, tdt)
    _close(got, oracle, tdt)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("s,t", [(64, 64), (48, 80), (80, 48), (100, 100)])
def test_flash_plain_grouped_and_ragged(jdt, tdt, s, t):
    """Group 3 (query row bh reads K/V row bh // 3) against the oracle on
    repeated K/V; S != T exercises the causal prefix offset (and, for
    S > T, rows that see no key); 100 is no block multiple."""
    rng = np.random.default_rng(7 + s + t)
    qj, qt = _pair(_normal(rng, (6, s, 32)), jdt, tdt)
    kj, kt = _pair(_normal(rng, (2, t, 32)), jdt, tdt)
    vj, vt = _pair(_normal(rng, (2, t, 32)), jdt, tdt)
    for causal in (True, False):
        got = FA.flash_attention_bhsd(qt, kt, vt, causal=causal)
        with _x32():
            want = RREF.flash_attention_ref(qj, jnp.repeat(kj, 3, axis=0),
                                            jnp.repeat(vj, 3, axis=0), causal=causal)
        _close(got, want, tdt)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_flash_model_layout_matches_reference_ops(jdt, tdt):
    """ops.flash_attention on grouped (B, T, KV, hd) K/V against the
    reference's ops.flash_attention on pre-broadcast K/V (Pallas,
    interpret mode), and on pre-broadcast K/V itself."""
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 64, 6, 2, 32
    qj, qt = _pair(_normal(rng, (B, S, H, hd)), jdt, tdt)
    kj, kt = _pair(_normal(rng, (B, S, KV, hd)), jdt, tdt)
    vj, vt = _pair(_normal(rng, (B, S, KV, hd)), jdt, tdt)
    with _x32():
        want = ROPS.flash_attention(qj, jnp.repeat(kj, 3, axis=2), jnp.repeat(vj, 3, axis=2),
                                    blk_q=32, blk_k=32)
    _close(ops.flash_attention(qt, kt, vt), want, tdt)
    krep, vrep = kt.repeat_interleave(3, dim=2), vt.repeat_interleave(3, dim=2)
    _close(ops.flash_attention(qt, krep, vrep), want, tdt)


# --------------------------------------------------------------------------- #
# decode_attention_bhd
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bh,s,hd", [(2, 128, 32), (4, 256, 64), (1, 64, 128)])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("pos_frac", [0.0, 0.3, 0.99])
def test_decode_plain_matches_pallas_and_oracle(bh, s, hd, jdt, tdt, pos_frac):
    rng = np.random.default_rng(1000 * bh + s + hd + int(100 * pos_frac))
    qj, qt = _pair(_normal(rng, (bh, hd)), jdt, tdt)
    kj, kt = _pair(_normal(rng, (bh, s, hd)), jdt, tdt)
    vj, vt = _pair(_normal(rng, (bh, s, hd)), jdt, tdt)
    p = int(pos_frac * (s - 1))
    got = DA.decode_attention_bhd(qt, kt, vt, torch.tensor(p, dtype=torch.int32))
    with _x32():
        pj = jnp.asarray(p, jnp.int32)
        kern = pallas_decode(qj, kj, vj, pj, blk_k=32, interpret=True)
        oracle = RREF.decode_attention_ref(qj, kj, vj, pj)
    _close(got, kern, tdt)
    _close(got, oracle, tdt)


@pytest.mark.parametrize("q_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 37, 79, -1])
def test_decode_plain_grouped_over_bf16_cache(q_dt, pos):
    """The serving case: query heads grouped 3 to a KV head over a bf16
    (B, S_max, KV, hd) cache, an f32 or bf16 query, against the reference
    ops.decode_attention on the pre-broadcast cache.  pos -1 leaves every
    row masked: the reference's softmax is then uniform."""
    rng = np.random.default_rng(11 + pos)
    B, S, H, KV, hd = 2, 80, 6, 2, 32
    jq = jnp.float32 if q_dt == torch.float32 else jnp.bfloat16
    qj, qt = _pair(_normal(rng, (B, 1, H, hd)), jq, q_dt)
    kj, kt = _pair(_normal(rng, (B, S, KV, hd)), jnp.bfloat16, torch.bfloat16)
    vj, vt = _pair(_normal(rng, (B, S, KV, hd)), jnp.bfloat16, torch.bfloat16)
    got = ops.decode_attention(qt, kt, vt, torch.tensor(pos, dtype=torch.int32))
    assert got.shape == (B, 1, H, hd)
    with _x32():
        want = RREF.decode_attention_ref(
            qj[:, 0].reshape(B * H, hd),
            jnp.moveaxis(jnp.repeat(kj, 3, axis=2), 2, 1).reshape(B * H, S, hd),
            jnp.moveaxis(jnp.repeat(vj, 3, axis=2), 2, 1).reshape(B * H, S, hd),
            jnp.asarray(pos, jnp.int32)).reshape(B, 1, H, hd)
    _close(got, want, q_dt)


# --------------------------------------------------------------------------- #
# Wrappers: dispatch, checks, counters
# --------------------------------------------------------------------------- #
def test_cpu_tensors_run_the_plain_versions_without_launching():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_normal(rng, (2, 16, 6, 32)))
    k = torch.from_numpy(_normal(rng, (2, 16, 2, 32)))
    pos = torch.tensor(9, dtype=torch.int32)
    f0, d0 = FA.flash_attention_bhsd.launches, DA.decode_attention_bhd.launches
    assert torch.equal(ops.flash_attention(q, k, k), FA.attention_ref(q, k, k))
    assert torch.equal(FA.flash_attention_bhsd(q[:, :, 0], k[:, :, 0], k[:, :, 0]),
                       FA.flash_attention_ref(q[:, :, 0], k[:, :, 0], k[:, :, 0]))
    assert torch.equal(ops.decode_attention(q[:, :1], k, k, pos),
                       DA.attention_ref(q[:, 0], k, k, pos).unsqueeze(1))
    assert torch.equal(DA.decode_attention_bhd(q[:, 0, 0], k[:, :, 0], k[:, :, 0], pos),
                       DA.decode_attention_ref(q[:, 0, 0], k[:, :, 0], k[:, :, 0], pos))
    assert (FA.flash_attention_bhsd.launches, DA.decode_attention_bhd.launches) == (f0, d0)


def test_strided_views_are_taken_as_they_are():
    """The plain versions read (B, S, H, hd) views with any strides on
    the first three axes, as the kernels do: a transposed copy gives the
    same result."""
    rng = np.random.default_rng(1)
    base = torch.from_numpy(_normal(rng, (2, 6, 24, 32)))
    q = base.transpose(1, 2)  # (2, 24, 6, 32), not contiguous
    k = base[:, :2].transpose(1, 2)
    assert not q.is_contiguous()
    torch.testing.assert_close(ops.flash_attention(q, k, k),
                               ops.flash_attention(q.contiguous(), k.contiguous(),
                                                   k.contiguous()), rtol=0, atol=0)


def test_argument_checks():
    f32 = torch.zeros(2, 8, 6, 32)
    kv = torch.zeros(2, 8, 2, 32)
    pos = torch.tensor(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.flash_attention(f32, kv.bfloat16(), kv.bfloat16())
    with pytest.raises(TypeError):
        ops.flash_attention(f32.double(), kv.double(), kv.double())
    with pytest.raises(ValueError):  # 6 query heads over 4 KV heads
        ops.flash_attention(f32, torch.zeros(2, 8, 4, 32), torch.zeros(2, 8, 4, 32))
    with pytest.raises(ValueError):  # head dim past 128
        ops.flash_attention(torch.zeros(1, 4, 1, 160), torch.zeros(1, 4, 1, 160),
                            torch.zeros(1, 4, 1, 160))
    with pytest.raises(ValueError):  # hd not contiguous
        ops.flash_attention(f32.transpose(2, 3), kv, kv)
    with pytest.raises(ValueError):  # 6 query rows over 4 K/V rows
        FA.flash_attention_bhsd(torch.zeros(6, 8, 32), torch.zeros(4, 8, 32),
                                torch.zeros(4, 8, 32))
    with pytest.raises(TypeError):  # pos must be int32
        ops.decode_attention(f32[:, :1], kv, kv, torch.tensor(3))
    with pytest.raises(TypeError):  # k and v of different dtypes
        ops.decode_attention(f32[:, :1], kv, kv.bfloat16(), pos)
    with pytest.raises(ValueError):  # cache of another batch
        ops.decode_attention(f32[:, :1], kv[:1], kv[:1], pos)


# --------------------------------------------------------------------------- #
# What the card computes: the kernels' arithmetic emulated on the CPU
# --------------------------------------------------------------------------- #
def _flash_tc_emulation(q, k, v, causal: bool, blk: int = 64) -> torch.Tensor:
    """The tensor-core flash kernel's arithmetic in plain torch: key tiles
    of ``blk``, scores in log2 units, an online softmax in f32, P rounded
    once to bf16 before P V (f32 accumulation), the row sum of the f32 P,
    the output rounded once.  ``(BH, S, hd)`` operands, group 1."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    BH, S, hd = q32.shape
    T = k32.shape[1]
    c2 = math.log2(math.e) / math.sqrt(hd)
    rows = torch.arange(S)[:, None]
    m = torch.full((BH, S, 1), -math.inf)
    l = torch.zeros(BH, S, 1)
    acc = torch.zeros(BH, S, hd)
    for kv0 in range(0, T, blk):
        kt, vt = k32[:, kv0:kv0 + blk], v32[:, kv0:kv0 + blk]
        s = (q32 @ kt.transpose(1, 2)) * c2
        if causal:
            cols = kv0 + torch.arange(kt.shape[1])[None, :]
            s = torch.where(cols <= rows + (T - S), s, torch.tensor(FA.MASKED))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def test_flash_tensor_core_arithmetic_fits_the_bf16_tolerance():
    """P rounded to bf16 before P V (what the card's tensor-core kernel and
    SDPA do) stays within the bf16 tolerance, 2e-2, of the Pallas kernel
    (interpret mode), the reference oracle and the port's plain version,
    at the serving path's head dim 64, causal S = T = 256."""
    rng = np.random.default_rng(17)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(_normal(rng, (3, 256, 64)), jnp.bfloat16, torch.bfloat16)
                                    for _ in range(3))
    got = _flash_tc_emulation(qt, kt, vt, causal=True)
    with _x32():
        kern = pallas_flash(qj, kj, vj, causal=True, blk_q=64, blk_k=64, interpret=True)
        oracle = RREF.flash_attention_ref(qj, kj, vj, causal=True)
    _close(got, kern, torch.bfloat16)
    _close(got, oracle, torch.bfloat16)
    _close(got, FA.flash_attention_ref(qt, kt, vt, causal=True).float(), torch.bfloat16)


def _split_decode_emulation(q, k, v, pos: int, rows: int) -> torch.Tensor:
    """The split / combine decode kernels' arithmetic in plain torch on
    ``(BH, hd)`` queries over ``(BH, S_max, hd)`` caches: splits of
    ``rows`` cache rows, each with its own max, sum and unnormalised
    accumulator, then merged in split order.  ``pos < 0`` leaves every row
    at -1e30 (a uniform softmax over all S_max rows)."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    S, hd = k32.shape[1], q32.shape[1]
    n = S if pos < 0 else min(pos, S - 1) + 1
    parts = []
    for t0 in range(0, n, rows):
        kt, vt = k32[:, t0:min(t0 + rows, n)], v32[:, t0:min(t0 + rows, n)]
        s = torch.einsum("bd,btd->bt", q32, kt) / math.sqrt(hd)
        if pos < 0:
            s = torch.full_like(s, FA.MASKED)
        m_s = s.amax(-1, keepdim=True)
        p = torch.exp(s - m_s)
        parts.append((m_s, p.sum(-1, keepdim=True), torch.einsum("bt,btd->bd", p, vt)))
    m = torch.stack([ms for ms, _, _ in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q32)
    for m_s, l_s, a_s in parts:
        w = torch.exp(m_s - m)
        l = l + w * l_s
        acc = acc + w * a_s
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("pos", [-1, 0, 127, 128, 319])
def test_split_decode_arithmetic_matches_pallas_and_oracle(jdt, tdt, pos):
    """Split-then-combine decode with the wrapper's split size (128 rows)
    at the edges of a split, pos -1 and the last row, against the Pallas
    kernel (interpret mode), the reference oracle and the port's plain
    version: f32 within 2e-6, bf16 within 2e-2.  At pos -1 the Pallas
    kernel skips every cache tile and returns zeros; the oracle's softmax
    (and the port's) is uniform over all rows, so only those two are held
    there."""
    rows = DA.SPLIT_ROWS
    assert rows == 128
    rng = np.random.default_rng(23 + pos)
    qj, qt = _pair(_normal(rng, (4, 64)), jdt, tdt)
    kj, kt = _pair(_normal(rng, (4, 320, 64)), jdt, tdt)
    vj, vt = _pair(_normal(rng, (4, 320, 64)), jdt, tdt)
    got = _split_decode_emulation(qt, kt, vt, pos, rows)
    with _x32():
        pj = jnp.asarray(pos, jnp.int32)
        oracle = RREF.decode_attention_ref(qj, kj, vj, pj)
        kern = pallas_decode(qj, kj, vj, pj, blk_k=64, interpret=True) if pos >= 0 else None
    _close(got, oracle, tdt)
    if kern is not None:
        _close(got, kern, tdt)
    _close(got, DA.decode_attention_ref(qt, kt, vt, torch.tensor(pos, dtype=torch.int32)).float(),
           tdt)


# --------------------------------------------------------------------------- #
# The wrappers' pure choices: flash variant, decode split count
# --------------------------------------------------------------------------- #
def _model_views(dt, hd, how):
    """(q, k, v, o) 4-D views of one kind: contiguous, a head slice of a
    wider tensor (the model's strided layout), or a start shifted by one
    element (rows not 16-byte aligned)."""
    B, S, H, KV = 2, 16, 6, 2
    if how == "contiguous":
        q = torch.zeros(B, S, H, hd, dtype=dt)
        k = torch.zeros(B, S, KV, hd, dtype=dt)
    elif how == "head_slice":
        q = torch.zeros(B, S, 3 * H, hd, dtype=dt)[:, :, H:2 * H]
        k = torch.zeros(B, S, 2 * KV, hd, dtype=dt)[:, :, KV:]
    else:  # shifted
        q = torch.zeros(B, S, H, hd + 1, dtype=dt)[..., 1:]
        k = torch.zeros(B, S, KV, hd + 1, dtype=dt)[..., 1:]
    return q, k, k, torch.empty(B, S, H, hd, dtype=dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 32, 36])
@pytest.mark.parametrize("how", ["contiguous", "head_slice", "shifted"])
def test_flash_variant_choice(dt, hd, how):
    """The tensor-core kernel takes bf16 operands whose rows all start
    16-byte aligned with hd % 8 == 0; every other case takes the f32
    kernel.  The choice reads the operands alone."""
    q, k, v, o = _model_views(dt, hd, how)
    want = "tc" if dt == torch.bfloat16 and hd % 8 == 0 and how != "shifted" else "simt"
    assert FA.kernel_variant(q, k, v, o) == want


def test_decode_split_count():
    """ceil(S_max / 128): from the cache's size alone, never from pos; the
    wrapper's split size is the kernel source's, which sizes the scratch."""
    src = (Path(DA.__file__).parent / "csrc" / "decode_attention.cu").read_text()
    assert f"constexpr int kSplitRows = {DA.SPLIT_ROWS};" in src
    assert DA.SPLIT_ROWS == 128
    assert [DA.split_count(s) for s in (1, 127, 128, 129, 1160, 4096, 4097)] == \
        [1, 1, 1, 2, 10, 32, 33]
