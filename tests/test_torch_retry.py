"""The port's failure classifier, retry policy and chaos primitives
(``repro_torch.ft.retry`` / ``injection``) against the reference's.

``classify_failure`` gives every reference case the reference's kind
(the synthetic chaos exceptions, every XLA pattern, the fatal types), and
the CUDA cases theirs: ``torch.OutOfMemoryError`` and a kernel wrapper's
``(cudaError 2)`` OOM, the sticky CUDA errors (by message, by the
wrappers' codes, by ``torch.AcceleratorError``) DEVICE_LOSS, and
``KernelBuildError`` and a wrapper's other launch failures FATAL.  ``RetryPolicy.backoff`` and
``ChaosInjector._u`` are the reference's bit for bit; the reference's
retry and chaos primitive tests run on the port ("jax" read as "torch");
``FaultInjector`` replays the reference's on the same trace.  No card is
needed; every call into ``repro`` sits inside ``jax.enable_x64(True)``.
"""

import stat

import jax
import numpy as np
import pytest
import torch

import repro.ft as RF
from repro.core.events import make_event_trace as ref_make_event_trace
from repro_torch.core.events import make_event_trace
from repro_torch.ft import (
    CampaignKilled,
    ChaosInjector,
    FailureKind,
    FaultInjector,
    RetryPolicy,
    SimulatedFault,
    SyntheticDeviceLoss,
    SyntheticOOM,
    SyntheticTorchFailure,
    classify_failure,
)
from repro_torch.kernels import build
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError
from repro_torch.kernels.sim_step import _raise_on


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


class _Tagged(RuntimeError):
    def __init__(self, kind):
        super().__init__("tagged")
        self.failure_kind = kind


#: (name, port exception, reference exception): every pattern and type the
#: reference's classifier knows, and the order it checks them in
REFERENCE_CASES = [
    ("synthetic_oom", SyntheticOOM(0), RF.SyntheticOOM(0)),
    ("synthetic_device_loss", SyntheticDeviceLoss(3, n_lost=2),
     RF.SyntheticDeviceLoss(3, n_lost=2)),
    ("synthetic_engine_failure", SyntheticTorchFailure(1), RF.SyntheticJaxFailure(1)),
    ("resource_exhausted", RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
     RuntimeError("RESOURCE_EXHAUSTED: out of memory")),
    *[(f"oom:{p}", RuntimeError(f"x {p} y"), RuntimeError(f"x {p} y"))
      for p in ("RESOURCE EXHAUSTED", "Resource exhausted", "Out of memory",
                "out of memory", "OOM")],
    *[(f"device_loss:{p}", RuntimeError(f"x {p} y"), RuntimeError(f"x {p} y"))
      for p in ("DEVICE_LOST", "device lost", "Device lost", "device is lost",
                "device unavailable", "NCCL")],
    # device loss is checked before OOM, and both before the fatal types
    ("loss_over_oom", RuntimeError("DEVICE_LOST after out of memory"),
     RuntimeError("DEVICE_LOST after out of memory")),
    ("nccl_value_error", ValueError("NCCL error"), ValueError("NCCL error")),
    ("oom_index_error", IndexError("out of memory"), IndexError("out of memory")),
    *[(f"fatal:{t.__name__}", t("bad arg"), t("bad arg"))
      for t in (TypeError, ValueError, KeyError, AttributeError, IndexError)],
    ("unknown", RuntimeError("???"), RuntimeError("???")),
    ("os_error", OSError("disk"), OSError("disk")),
    # the type name takes part in the match
    ("oom_type_name", type("OOMError", (RuntimeError,), {})("x"),
     type("OOMError", (RuntimeError,), {})("x")),
]
REFERENCE_CASES += [
    (f"tagged:{k.value}", _Tagged(FailureKind(k.value)), _Tagged(k))
    for k in RF.FailureKind
]


@pytest.mark.parametrize("name,port_exc,ref_exc", REFERENCE_CASES,
                         ids=[c[0] for c in REFERENCE_CASES])
def test_classify_reference_cases(name, port_exc, ref_exc):
    assert classify_failure(port_exc).value == RF.classify_failure(ref_exc).value


_STICKY_MESSAGES = (
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: device-side assert triggered\nCUDA kernel errors might be "
    "asynchronously reported at some other API call",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "CUDA error: no CUDA-capable device is detected",
)

#: (name, exception, kind) of the card's failures
CUDA_CASES = [
    ("torch_oom", torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"), FailureKind.OOM),
    # a torch OOM whose text names no pattern: by type
    ("torch_oom_type", torch.OutOfMemoryError("allocator refused"), FailureKind.OOM),
    ("wrapper_oom", RuntimeError(
        "masked_primitive_update: kernel launch failed (cudaError 2)"), FailureKind.OOM),
    *[(f"sticky_message:{i}", RuntimeError(m), FailureKind.DEVICE_LOSS)
      for i, m in enumerate(_STICKY_MESSAGES)],
    *[(f"wrapper_sticky:{c}", RuntimeError(
        f"masked_strike_walk: kernel launch failed (cudaError {c})"),
       FailureKind.DEVICE_LOSS) for c in (700, 719, 710, 214, 46, 100)],
    # codes that are neither (a bad launch configuration, an image the card
    # cannot run): the kernel's own fault, never retried or degraded
    *[(f"wrapper_other:{c}", RuntimeError(
        f"quantize_blocks: kernel launch failed (cudaError {c})"),
       FailureKind.FATAL) for c in (1, 9, 20, 21, 200, 209)],
    # the wrappers raise KernelLaunchError: its code decides, as its text does
    *[(f"launch_error:{c}", KernelLaunchError("masked_primitive_update", c), kind)
      for c, kind in ((2, FailureKind.OOM), (700, FailureKind.DEVICE_LOSS),
                      (710, FailureKind.DEVICE_LOSS), (200, FailureKind.FATAL),
                      (209, FailureKind.FATAL), (701, FailureKind.FATAL))],
    # a sticky error whose text also says "out of memory": the context is gone
    ("sticky_before_oom", RuntimeError(
        "CUDA error: an illegal memory access was encountered (out of memory?)"),
     FailureKind.DEVICE_LOSS),
    ("build_nvcc_missing", KernelBuildError("nvcc not found"), FailureKind.FATAL),
    # the build error wins over every pattern its compiler log may hold
    ("build_log_patterns", KernelBuildError(
        "nvcc failed for ['sim_step']:\nout of memory; device lost; "
        "(cudaError 700)"), FailureKind.FATAL),
]


@pytest.mark.parametrize("name,exc,kind", CUDA_CASES, ids=[c[0] for c in CUDA_CASES])
def test_classify_cuda_cases(name, exc, kind):
    assert classify_failure(exc) is kind


def test_classify_accelerator_error_by_type():
    """A sticky error raised as ``torch.AcceleratorError`` (torch >= 2.8)
    is a device loss whatever its text; a torch without the type keeps
    the message rules."""
    acc = getattr(torch, "AcceleratorError", None)
    if acc is None:
        pytest.skip("this torch has no torch.AcceleratorError")
    assert classify_failure(acc("CUDA error: misaligned address")) is (
        FailureKind.DEVICE_LOSS)
    assert not issubclass(torch.OutOfMemoryError, acc)


def test_kernel_build_error_is_a_runtime_error():
    assert issubclass(KernelBuildError, RuntimeError)


def test_wrappers_raise_kernel_launch_error():
    """A wrapper's non-zero ``cudaError_t`` becomes a ``KernelLaunchError``
    that carries the code and the text the classifier also reads."""
    assert issubclass(KernelLaunchError, RuntimeError)
    _raise_on("masked_primitive_update", 0)
    with pytest.raises(KernelLaunchError,
                       match=r"masked_primitive_update: kernel launch failed \(cudaError 209\)"
                       ) as info:
        _raise_on("masked_primitive_update", 209)
    assert info.value.code == 209


def test_unloadable_library_raises_kernel_build_error(monkeypatch, tmp_path):
    """A library that is there but does not load (a file that is no shared
    object) is a build fault, not a transient ``OSError``."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    lib = build._lib_path("sim_step")
    lib.write_bytes(b"not an ELF file")
    with pytest.raises(KernelBuildError, match="cannot load the library of sim_step"):
        build.load("sim_step")
    assert "sim_step" not in build._libs


def test_nvcc_missing_raises_kernel_build_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        build._nvcc()


def test_failed_build_raises_kernel_build_error(monkeypatch, tmp_path):
    """A compiler that exits non-zero: ``_build_missing`` raises
    ``KernelBuildError`` with its log (a stand-in script, not nvcc)."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: stand-in compiler refused'\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    with pytest.raises(KernelBuildError, match="stand-in compiler refused"):
        build._build_missing(["sim_step"])
    assert not list((tmp_path / "out").glob("*.so"))


# --------------------------------------------------------------------------- #
# Bit-equal draws
# --------------------------------------------------------------------------- #
COUNTERS = (0, 1, 2, 63, 64, 65, 1000, 2**32 - 1, 2**32 + 5, 2**63 + 7, 2**64 - 1)


@pytest.mark.parametrize("seed", [0, 4, 2**40 + 3, 2**64 - 1])
def test_backoff_bit_equal(seed):
    kw = dict(base=0.05, factor=2.0, jitter=0.5, seed=seed)
    port, ref = RetryPolicy(**kw), RF.RetryPolicy(**kw)
    for attempt in range(6):
        for ctr in COUNTERS:
            assert port.backoff(attempt, ctr) == ref.backoff(attempt, ctr)


@pytest.mark.parametrize("seed", [0, 3, 1000, 1001, 2**50 + 9])
def test_chaos_u_bit_equal(seed):
    port, ref = ChaosInjector(seed=seed), RF.ChaosInjector(seed=seed)
    for inc in (0, 1, 2, 7, 0xFFFF, 0x1FFFF):
        for chunk in (0, 1, 2, 5, 63, 2**31, 2**32 + 1):
            for slot in (0, 1, 2, 255, 256):
                assert port._u(inc, chunk, slot) == ref._u(inc, chunk, slot)


def test_pause_sleeps_the_backoff():
    slept = []
    pol = RetryPolicy(seed=9, sleep=slept.append)
    dt = pol.pause(2, 130)
    assert slept == [dt] and dt == RF.RetryPolicy(seed=9).backoff(2, 130)


# --------------------------------------------------------------------------- #
# The reference's retry / chaos primitive tests, on the port
# --------------------------------------------------------------------------- #
def test_classifier():
    assert classify_failure(SyntheticOOM(0)) is FailureKind.OOM
    assert classify_failure(SyntheticDeviceLoss(0)) is FailureKind.DEVICE_LOSS
    assert classify_failure(SyntheticTorchFailure(0)) is FailureKind.TRANSIENT
    assert classify_failure(
        RuntimeError("RESOURCE_EXHAUSTED: out of memory")
    ) is FailureKind.OOM
    assert classify_failure(ValueError("bad arg")) is FailureKind.FATAL
    assert classify_failure(RuntimeError("???")) is FailureKind.TRANSIENT


def test_backoff_deterministic_and_bounded():
    pol = RetryPolicy(base=0.1, factor=2.0, jitter=0.5, seed=4)
    a = [pol.backoff(k, counter=k) for k in range(4)]
    b = [pol.backoff(k, counter=k) for k in range(4)]
    assert a == b  # counter-keyed jitter replays
    for k, dt in enumerate(a):
        assert 0.1 * 2 ** k <= dt <= 0.1 * 2 ** k * 1.5


def test_campaign_killed_is_not_an_exception():
    assert not issubclass(CampaignKilled, Exception)
    assert issubclass(CampaignKilled, BaseException)


def test_chaos_scheduled_fire_once():
    ch = ChaosInjector(oom_at=(2,))
    ch.at_chunk_boundary(0)
    ch.at_chunk_boundary(1)
    with pytest.raises(SyntheticOOM):
        ch.at_chunk_boundary(2)
    ch.at_chunk_boundary(2)  # already fired: retry proceeds


def test_chaos_retries_skip_scheduled():
    ch = ChaosInjector(oom_at=(0,), kill_at=(0,))
    ch.at_chunk_boundary(0, attempt=1)  # nothing fires on retries


def test_chaos_torch_failure_persists_until_degraded():
    ch = ChaosInjector(torch_fail_at=1)
    ch.at_chunk_boundary(0)
    for attempt in range(3):
        with pytest.raises(SyntheticTorchFailure):
            ch.at_chunk_boundary(1, attempt=attempt)
    with pytest.raises(SyntheticTorchFailure):
        ch.at_chunk_boundary(5, incarnation=2, attempt=1)
    ch.at_chunk_boundary(5, engine="batch")  # bug lives in the torch path


def test_chaos_torch_failure_first_attempt_only():
    ch = ChaosInjector(torch_fail_at=1, torch_fail_persistent=False)
    with pytest.raises(SyntheticTorchFailure):
        ch.at_chunk_boundary(1)
    ch.at_chunk_boundary(1, attempt=1)


def test_chaos_budget_bounds_probabilistic_fires():
    ch = ChaosInjector(seed=3, p_oom=1.0, max_fires=2)
    fired = 0
    for k in range(10):
        try:
            ch.at_chunk_boundary(k)
        except SyntheticOOM:
            fired += 1
    assert fired == 2


def test_chaos_kill_mode_checked():
    with pytest.raises(ValueError, match="kill_mode"):
        ChaosInjector(kill_mode="sigterm")
    with pytest.raises(ValueError, match="kill_mode"):
        RF.ChaosInjector(kill_mode="sigterm")


@pytest.mark.parametrize("seed", [1000, 1001, 5])
def test_chaos_fires_as_reference(seed):
    """The same probabilistic schedule fires the same exceptions, chunk by
    chunk and incarnation by incarnation (the kill raised, not sent)."""
    kw = dict(seed=seed, p_kill=0.25, p_oom=0.2, p_device_loss=0.15, max_fires=5)
    port, ref = ChaosInjector(**kw), RF.ChaosInjector(**kw)

    def fire(ch, chunk, inc, attempt, engine):
        try:
            ch.at_chunk_boundary(chunk, incarnation=inc, attempt=attempt, engine=engine)
        except BaseException as e:  # noqa: BLE001 - CampaignKilled included
            return type(e).__name__.replace("Jax", "Torch"), getattr(e, "chunk", None)
        return None

    for inc in range(3):
        for chunk in range(12):
            for attempt in range(2):
                assert fire(port, chunk, inc, attempt, "torch") == fire(
                    ref, chunk, inc, attempt, "jax")
    assert port.n_fires == ref.n_fires


# --------------------------------------------------------------------------- #
# Executor-level injection on the port's EventTrace
# --------------------------------------------------------------------------- #
def test_fault_injector_replays_reference():
    horizon, mtbf = 2e5, 7000.0
    trace = make_event_trace(np.random.default_rng(11), horizon, mtbf, 0.85, 0.82,
                             window=600.0)
    ref_trace = ref_make_event_trace(np.random.default_rng(11), horizon, mtbf, 0.85, 0.82,
                                     window=600.0)
    port, ref = FaultInjector(trace), RF.FaultInjector(ref_trace)
    assert port.fault_times == ref.fault_times and port.predicted == ref.predicted
    assert len(port.fault_times) > 4
    port.cancel(port.fault_times[2])
    ref.cancel(ref.fault_times[2])
    seen = []
    for now in np.linspace(0.0, horizon, 97):
        for inj, tag in ((port, "port"), (ref, "ref")):
            try:
                inj.check(float(now))
            except (SimulatedFault, RF.SimulatedFault) as e:
                seen.append((tag, e.time, e.predicted, str(e)))
        assert port.peek() == ref.peek()
    got = [s[1:] for s in seen if s[0] == "port"]
    assert got == [s[1:] for s in seen if s[0] == "ref"]
    assert got and all(t != port.fault_times[2] for t, _, _ in got)
