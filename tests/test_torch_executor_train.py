"""``repro_torch.launch.train.train`` on the CPU through every checkpoint
tier and codec (``raw``, ``int8``, ``int8_delta``): faults restored from
the memory, disk and initial tiers, a correlated failure sending every
second checkpoint restore to disk.  Kept apart from
``tests/test_torch_executor.py`` so that a run that spreads test files over
workers runs these three long cases beside that file's tests.
"""

import math

import pytest

from repro_torch import configs
from repro_torch.launch import train as TR


class _TickClock:
    """A wall clock that is not the wall's: each reading advances it by a
    fixed tick, so a run's fault and checkpoint times do not depend on the
    machine's speed."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        self.t += 0.02
        return self.t

    def advance(self, dt: float) -> None:
        pass


@pytest.mark.parametrize("codec", ["raw", "int8", "int8_delta"])
def test_train_through_every_tier_and_codec(tmp_path, codec, monkeypatch):
    """Faults through the memory, disk and initial tiers: every restore
    names its tier, the losses stay finite (the delta base leaves the
    second moments out, so no restored v goes below 0), and a correlated
    failure sends every second checkpoint restore to disk."""
    monkeypatch.setattr(TR, "WallClock", _TickClock)
    cfg = configs.get("smollm-135m").reduced()
    res = TR.train(cfg, steps=100, batch=2, seq=32, seed=1, codec=codec, memory_tier=True,
                   correlated_every=2, inject_faults=True, fault_mtbf=3.0,
                   predictor="paper-accurate", device="cpu", ckpt_dir=str(tmp_path),
                   log=lambda s: None)
    rep = res["report"]
    assert rep.steps_done == 100 and rep.n_restores == rep.n_faults == len(res["restores"])
    assert all(math.isfinite(v) for v in res["losses"].values())
    tiers = [r["tier"] for r in res["restores"]]
    assert set(tiers) <= {"memory", "disk", "initial"}
    ckpt = [t for t in tiers if t != "initial"]
    assert ckpt and ckpt[0::2] == ["memory"] * len(ckpt[0::2])
    assert ckpt[1::2] == ["disk"] * len(ckpt[1::2])
    assert all(s["c_block"] >= s["c_block_disk"] > 0 for s in res["saves"])
    assert all("c_full" in s for s in res["saves"])
    assert res["losses"][99] < res["losses"][0]
