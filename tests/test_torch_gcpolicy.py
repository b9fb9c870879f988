"""The collector's policy of a serving process (``bftkv_tpu_torch/gcpolicy.py``):
the dispatch plane and the verify sidecar's service each hold it while they
run, it sets the young thresholds once however many hold it, the last owner
to go restores the interpreter's settings, and the idle ledger's hook counts
full collections by generation.  Every test leaves the interpreter's ``gc``
settings as it found them."""

from __future__ import annotations

import gc
import sys
import threading

import pytest

from bftkv_tpu_torch import gcpolicy
from bftkv_tpu_torch.cmd import verify_sidecar as vs
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import dispatch


@pytest.fixture()
def before():
    """The collector's settings with no owner holding the policy: (its
    thresholds, its freeze count); restored after the test."""
    dispatch.uninstall_all()
    for owner in list(gcpolicy._owners):  # a service another test left running
        gcpolicy.release(owner)
    state = (gc.get_threshold(), gc.get_freeze_count())
    try:
        yield state
    finally:
        dispatch.uninstall_all()
        for owner in list(gcpolicy._owners):
            gcpolicy.release(owner)
        gc.set_threshold(*state[0])


def _verifier():
    return dispatch.VerifyDispatcher(rsa.VerifierDomain(device="cpu"), calibrate=False)


def _signer():
    return dispatch.SignDispatcher(rsa.SignerDomain(device="cpu"), calibrate=False)


def _count_sets(monkeypatch) -> list:
    """Records every ``gc.set_threshold`` call."""
    calls = []
    set_threshold = gc.set_threshold

    def counting(*t):
        calls.append(t)
        set_threshold(*t)

    monkeypatch.setattr(gc, "set_threshold", counting)
    return calls


def _applied() -> bool:
    return gc.get_threshold()[:2] == gcpolicy.YOUNG_THRESHOLDS


def _assert_as_before(state) -> None:
    assert (gc.get_threshold(), gc.get_freeze_count()) == state


def _run_at_once(targets) -> None:
    gate = threading.Barrier(len(targets))

    def go(target):
        gate.wait(timeout=30)
        target()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=go, args=(t,)) for t in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)


def test_the_first_install_applies_the_policy_and_only_once(before, monkeypatch):
    sets = _count_sets(monkeypatch)
    dispatch.install(_verifier())
    assert _applied() and len(sets) == 1
    assert gc.get_threshold() == (*gcpolicy.YOUNG_THRESHOLDS, before[0][2])
    dispatch.install_signer(_signer())
    dispatch.install(_verifier())  # a replacement: the plane stays installed
    assert len(sets) == 1 and _applied()
    assert gcpolicy.apply(dispatch._GC_OWNER) is False


def test_the_policy_neither_freezes_nor_turns_collection_off(before):
    dispatch.install(_verifier())
    assert _applied() and gc.isenabled()
    assert gc.get_freeze_count() == before[1]


def test_uninstall_all_restores_the_thresholds(before):
    gc.set_threshold(900, 11, 12)  # settings the process had chosen
    chosen = (gc.get_threshold(), gc.get_freeze_count())
    dispatch.install(_verifier())
    dispatch.install_signer(_signer())
    assert gc.get_threshold() != chosen[0]
    dispatch.uninstall_all()
    _assert_as_before(chosen)


def test_the_policy_holds_until_the_planes_last_dispatcher_goes(before):
    dispatch.install(_verifier())
    dispatch.install_signer(_signer())
    dispatch.uninstall()
    assert _applied()
    dispatch.uninstall_signer()
    _assert_as_before(before)


def test_install_and_uninstall_cycles_leave_the_process_as_it_was(before, monkeypatch):
    sets = _count_sets(monkeypatch)
    for k in range(3):
        dispatch.install(_verifier())
        dispatch.install_signer(_signer())
        assert _applied() and len(sets) == 2 * k + 1
        dispatch.uninstall_all()
        assert len(sets) == 2 * k + 2
        _assert_as_before(before)


def test_eight_threads_installing_at_once_apply_it_once(before, monkeypatch):
    sets = _count_sets(monkeypatch)
    dispatchers = [m() for m in [_verifier, _signer] * 4]
    installers = [dispatch.install, dispatch.install_signer] * 4
    _run_at_once([lambda i=i, d=d: i(d) for i, d in zip(installers, dispatchers)])
    assert len(sets) == 1 and _applied()
    assert dispatch.get() in dispatchers and dispatch.get_signer() in dispatchers
    dispatch.uninstall_all()
    _assert_as_before(before)


def test_eight_owners_applying_at_once_set_the_thresholds_once(before):
    owners = [object() for _ in range(8)]
    applied = []
    _run_at_once([lambda o=o: applied.append(gcpolicy.apply(o)) for o in owners])
    assert sorted(applied) == [False] * 7 + [True] and _applied()
    _run_at_once([lambda o=o: gcpolicy.release(o) for o in owners])
    _assert_as_before(before)


def test_a_release_by_an_owner_that_holds_nothing_changes_nothing(before):
    gcpolicy.release("nobody")
    _assert_as_before(before)
    gcpolicy.apply("a")
    gcpolicy.release("b")
    assert _applied()
    gcpolicy.release("a")
    gcpolicy.release("a")
    _assert_as_before(before)


def test_the_sidecar_service_holds_the_policy_while_it_runs(before):
    service = vs.SidecarService(device="cpu")
    try:
        assert _applied()
    finally:
        service.stop()
    _assert_as_before(before)
    service.stop()  # a second stop restores nothing twice
    _assert_as_before(before)


def test_a_sidecar_and_the_plane_in_one_process_each_hold_it(before):
    service = vs.SidecarService(device="cpu")
    try:
        dispatch.install(_verifier())
        dispatch.uninstall_all()
        assert _applied()  # the service still runs
        dispatch.install_signer(_signer())
    finally:
        service.stop()
    assert _applied()  # the plane is still installed
    dispatch.uninstall_all()
    _assert_as_before(before)


def test_a_forced_full_collection_advances_the_generation_2_counters(before):
    s0 = metrics.snapshot()
    gc.collect(2)
    s1 = metrics.snapshot()
    assert s1["process.gc.gen2.collections"] == s0["process.gc.gen2.collections"] + 1
    assert s1["process.gc.gen2.seconds"] > s0["process.gc.gen2.seconds"]
    assert s1["process.gc.collections"] >= s0["process.gc.collections"] + 1
    text = metrics.prometheus()
    assert "# TYPE bftkv_process_gc_gen2_collections_total counter" in text
    assert "# TYPE bftkv_process_gc_gen2_seconds_total counter" in text


def test_young_collections_count_under_their_own_generation(before):
    s0 = metrics.snapshot()
    gc.collect(0)
    gc.collect(1)
    s1 = metrics.snapshot()
    for g in (0, 1):
        assert s1[f"process.gc.gen{g}.collections"] >= s0[f"process.gc.gen{g}.collections"] + 1
