"""On a CUDA card: the port's hot-step kernels (``csrc/sim_step.cu``)
against their plain PyTorch versions, both the single-law and the
law-indexed variant, and each law's lanes of the indexed launch against
the single-law launch.  Imports neither JAX nor the reference, so it runs
on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sim_step_card.py

Without a card every test skips.

Tolerances: every output equal to the plain version's except the cursor
date ``tm`` (libdevice against ATen transcendentals, within 4 ulp); on
each law's lanes the indexed launch gives the single-law launch's bits
(0 ulp)."""

import pytest
import torch

from repro_torch.kernels import sim_step as K

LAWS = [("exponential", 0.0), ("weibull", 0.7), ("weibull", 0.5),
        ("lognormal", 1.0), ("uniform", 0.0)]

_PRIM_ARGS = ("prim", "cont", "target", "ckend", "nf", "t", "saved",
              "unsaved", "pw", "W", "DR")


def _lane_inputs(L: int, seed: int) -> dict:
    return K.sample_lane_state(L, seed)


def _torch_args(x: dict) -> dict:
    return K.lane_state_tensors(x, "cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    same = a == b
    d = (a.view(torch.int64) - b.view(torch.int64)).abs()
    return int(torch.where(same, torch.zeros_like(d), d).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,param", LAWS)
def test_kernels_match_plain_versions_on_card(cuda_device, kind, param):
    tx = {k: v.to(cuda_device) for k, v in _torch_args(_lane_inputs(100_000, 12)).items()}
    s = {k: v.clone() for k, v in tx.items()}
    stream = lambda d: (d["key"], d["ctr"], d["nf"], d["mean"], d["horizon"])  # noqa: E731
    want = K.primitive_update(*(tx[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1,
                              stream=stream(tx), gap=(kind, param))
    got = K.masked_primitive_update(*(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1,
                                    stream=stream(s), gap=(kind, param))
    for g, w in zip(got[:6], want[:6]):
        assert torch.equal(g, w)
    assert _ulps(got[6], want[6]) <= 4
    s = {k: v.clone() for k, v in tx.items()}
    wc, wt = K.stream_advance(tx["mask"], tx["ctr"], tx["nf"], tx["key"], tx["mean"],
                              tx["horizon"], kind=kind, param=param)
    gc, gt = K.masked_stream_advance(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"],
                                     s["horizon"], kind=kind, param=param)
    assert torch.equal(gc, wc)
    assert _ulps(gt, wt) <= 4


def _indexed_lanes(dev, L: int, seed: int, block: int):
    x = {**K.sample_lane_state(L, seed), **K.sample_lane_laws(L, seed + 1, block)}
    return {k: v.to(dev) for k, v in K.lane_state_tensors(x, "cpu").items()}


def _indexed_run(tx, plain: bool):
    s = {k: v.clone() for k, v in tx.items()}
    prim = K.primitive_update if plain else K.masked_primitive_update
    adv = K.stream_advance if plain else K.masked_stream_advance
    p = prim(*(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1, gap=("indexed", 0.0),
             stream=(s["key"], s["ctr"], s["nf"], s["mean"], s["horizon"],
                     s["law"], s["s1"], s["s2"]))
    s = {k: v.clone() for k, v in tx.items()}
    a = adv(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"], s["horizon"],
            kind="indexed", param=0.0, law=s["law"], lp=(s["s1"], s["s2"]))
    return p, a


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 1000])
def test_indexed_kernels_match_plain_versions_on_card(cuda_device, block):
    tx = _indexed_lanes(cuda_device, 100_000, 13, block)
    n0 = (K.masked_primitive_update.indexed_launches, K.masked_stream_advance.indexed_launches)
    (gp, ga), (wp, wa) = _indexed_run(tx, False), _indexed_run(tx, True)
    assert (K.masked_primitive_update.indexed_launches,
            K.masked_stream_advance.indexed_launches) == (n0[0] + 1, n0[1] + 1)
    for g, w in zip(gp[:6], wp[:6]):
        assert torch.equal(g, w)
    assert _ulps(gp[6], wp[6]) <= 4
    assert torch.equal(ga[0], wa[0]) and _ulps(ga[1], wa[1]) <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("li", range(len(K.SAMPLE_LAWS)))
def test_indexed_kernels_give_single_law_bits_on_card(cuda_device, li):
    kind, param = K.SAMPLE_LAWS[li]
    tx = _indexed_lanes(cuda_device, 100_000, 14, 1)
    gp, ga = _indexed_run(tx, False)
    s = {k: v.clone() for k, v in tx.items()}
    sp = K.masked_primitive_update(*(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1,
                                   stream=(s["key"], s["ctr"], s["nf"], s["mean"],
                                           s["horizon"]), gap=(kind, param))
    s = {k: v.clone() for k, v in tx.items()}
    sa = K.masked_stream_advance(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"],
                                 s["horizon"], kind=kind, param=param)
    on = tx["pick"] == li
    for g, w in zip(gp + ga, sp + sa):
        assert torch.equal(g[on], w[on])  # 0 ulp on this law's lanes
