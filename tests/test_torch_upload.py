"""The entry layer's upload (staging.py, engine._on_device) on the CPU.

The chunk plan covers every byte once; ``_on_device`` on a CPU device
gives what it gave before the staging ring existed and never asks for a
ring; its errors are unchanged; the upload counter starts at 0 after
``reset_launch_counts()``.  The ring's chunk loop runs here on a stand-in
card (CPU tensors, events that log) with its own copy threads, so its
bookkeeping is checked without one: the bytes arrive, slots are taken
in turn, no more copies run at once than it has copy threads, a slot is
refilled only after a wait on its event and its DMA is issued only after
its copy, a failed copy raises and leaves the ring serving, and threads
sharing a ring never share a slot.  The card's own tests are in
test_torch_gpu.py.
"""

import time

import numpy as np
import pytest
import torch

from ug_stereomatcher_tpu_torch import StereoEngine, scene, staging
from ug_stereomatcher_tpu_torch.engine import _on_device
from ug_stereomatcher_tpu_torch.ops.cuda import _build

SLOT = 64
PLAN_CASES = {
    "empty": 0,
    "one_byte": 1,
    "under_a_slot": SLOT - 1,
    "one_slot": SLOT,
    "one_slot_and_a_byte": SLOT + 1,
    "many_slots": 7 * SLOT,
    "many_slots_and_a_remainder": 7 * SLOT + 13,
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_chunk_plan_covers_every_byte_once(case):
    n = PLAN_CASES[case]
    plan = staging.chunk_plan(n, SLOT)
    seen = np.zeros(n, np.int64)
    for a, b in plan:
        assert 0 <= a < b <= n and b - a <= SLOT
        seen[a:b] += 1
    assert (seen == 1).all()
    assert [a for a, _ in plan] == sorted(a for a, _ in plan)
    assert len(plan) == -(-n // SLOT)


@pytest.mark.parametrize("slot_bytes", [0, -4])
def test_chunk_plan_refuses_an_empty_slot(slot_bytes):
    with pytest.raises(ValueError, match="slot_bytes"):
        staging.chunk_plan(10, slot_bytes)


def _never(device):
    raise AssertionError(f"a ring was asked for on {device}")


def _image(seed=0, shape=(12, 17, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


IMAGES = {
    "hwc": (lambda: _image(), 3, lambda a: a.transpose(2, 0, 1)),
    "chw": (lambda: _image(shape=(3, 12, 17)), 3, lambda a: a),
    "flipped_hwc": (lambda: _image()[::-1, ::-1], 3,
                    lambda a: a.transpose(2, 0, 1)),
    "float_hwc": (lambda: _image().astype(np.float32), 3,
                  lambda a: a.transpose(2, 0, 1)),
    "batch_bhwc": (lambda: _image(shape=(2, 12, 17, 3)), 4,
                   lambda a: a.transpose(0, 3, 1, 2)),
    "batch_bchw": (lambda: _image(shape=(2, 3, 12, 17)), 4, lambda a: a),
    "tensor_hwc": (lambda: torch.from_numpy(_image()), 3,
                   lambda a: a.numpy().transpose(2, 0, 1)),
}


@pytest.mark.parametrize("case", sorted(IMAGES))
def test_on_device_on_the_cpu_is_unchanged(case):
    make, ndim, chw = IMAGES[case]
    image = make()
    want = np.ascontiguousarray(chw(image))
    for ring_of in (None, _never):
        got = _on_device(image, torch.device("cpu"), ndim, ring_of)
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ndim,shape,what", [
    (3, (12, 17), "3-D RGB image"), (3, (1, 12, 17, 3), "3-D RGB image"),
    (4, (12, 17, 3), "a 4-D batch")])
def test_wrong_ndim_message_is_unchanged(ndim, shape, what):
    with pytest.raises(ValueError) as err:
        _on_device(np.zeros(shape, np.uint8), torch.device("cpu"), ndim,
                   _never)
    assert str(err.value) == f"expected {what}, got shape {shape}"


def test_upload_counter_starts_at_zero_after_reset():
    _build.record_upload("staged", 96)
    _build.record_upload("pinned", 4)
    assert _build.upload_bytes() == {"staged": 96, "pinned": 4}
    _build.reset_launch_counts()
    assert _build.upload_bytes() == {"staged": 0, "pinned": 0}


def test_cpu_engine_stages_nothing():
    left, right = scene.make_pair(48, 64)
    eng = StereoEngine(device="cpu")
    _build.reset_launch_counts()
    eng._pair(left, right)
    assert _build.upload_bytes() == {"staged": 0, "pinned": 0}
    assert eng._rings == {}


def test_ring_refuses_a_cpu_device_and_no_copy_thread():
    with pytest.raises(ValueError, match="indexed CUDA device"):
        staging.StagingRing(torch.device("cpu"))
    with pytest.raises(ValueError, match="a copy thread"):
        staging.StagingRing(torch.device("cuda", 0), copiers=0)


@pytest.mark.parametrize("cores,threads", [(1, 1), (3, 3), (8, 8),
                                           (32, staging.COPY_THREADS)])
def test_copy_threads_never_exceed_the_cores(cores, threads):
    assert staging.copy_threads(cores) == min(threads, staging.COPY_THREADS)
    ring = staging.StagingRing(torch.device("cuda", 0), 64,
                               staging.copy_threads(cores))
    assert ring.n_slots == ring.copiers + staging.DMA_SLOTS


class _LoggedEvent:
    """A stand-in for a slot's CUDA event: logs its waits and records,
    and checks at each record that the slot's host copy has finished."""

    def __init__(self, k, ring):
        self.k, self.ring = k, ring

    def synchronize(self):
        self.ring.log.append(("wait", self.k))

    def record(self, stream):
        assert self.ring.jobs[self.k][-1].done()
        self.ring.log.append(("record", self.k))


def _stand_in_ring(monkeypatch, slot_bytes, copiers, fail_at=None,
                   slow_at=None):
    """A ring whose card is the CPU: CPU slots, logging events, no
    stream; the chunk loop, the copy threads and the copies are the
    ring's own.  ``fail_at``: the host copy that raises as it starts;
    ``slow_at``: a copy thread's copy that takes 0.3 s."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    ring = staging.StagingRing(torch.device("cuda", 0), slot_bytes, copiers)
    ring.device = torch.device("cpu")
    ring.log, ring.busy, ring.jobs = [], [], {}
    real_copy = ring._copy

    def start():   # the ring's _start with CPU slots and logged events
        ring._slots = [torch.zeros(slot_bytes, dtype=torch.uint8)
                       for _ in range(ring.n_slots)]
        ring._events = [_LoggedEvent(k, ring) for k in range(ring.n_slots)]
        from concurrent.futures import ThreadPoolExecutor
        ring._pool = ThreadPoolExecutor(copiers)

    def copy(k, src_b, a, b):   # log which slot each copy fills
        ring.busy.append(sum(not j.done() for js in ring.jobs.values()
                             for j in js))
        ring.log.append(("write", k))
        if fail_at is not None and len(ring.busy) == fail_at:
            raise OSError("copy failed")
        if len(ring.busy) == slow_at:
            def slow():
                time.sleep(0.3)
                ring._slots[k][:b - a].copy_(src_b[a:b])
            job = ring._pool.submit(slow)
        else:
            job = real_copy(k, src_b, a, b)
        ring.jobs.setdefault(k, []).append(job)
        return job
    monkeypatch.setattr(ring, "_start", start)
    monkeypatch.setattr(ring, "_copy", copy)
    return ring


def _writes(ring):
    return [k for what, k in ring.log if what == "write"]


COPIERS = [1, 2, 3]


@pytest.mark.parametrize("copiers", COPIERS)
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_ring_moves_every_byte_on_a_stand_in_card(monkeypatch, case,
                                                  copiers):
    n = PLAN_CASES[case]
    ring = _stand_in_ring(monkeypatch, SLOT, copiers)
    src = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, n, np.uint8))
    _build.reset_launch_counts()
    got = ring.upload(src)
    assert got.shape == src.shape and torch.equal(got, src)
    assert n == 0 or got.data_ptr() != src.data_ptr()   # the ring's copy
    assert _writes(ring) == [i % ring.n_slots for i in range(
        len(staging.chunk_plan(n, SLOT)))]
    assert max(ring.busy, default=0) < copiers   # at most copiers at once
    assert _build.upload_bytes() == {"staged": n, "pinned": 0}


@pytest.mark.parametrize("copiers", COPIERS)
def test_ring_waits_on_a_slot_before_it_refills_it(monkeypatch, copiers):
    """Per slot, across uploads: a wait, the copy into it, its DMA's
    record (after the copy finished), in that order every time, the
    slots taken in turn."""
    ring = _stand_in_ring(monkeypatch, SLOT, copiers)
    shapes = ((5, 7, 3), (2, 9, 11, 3), (30, 17, 3))
    for seed, shape in enumerate(shapes):
        src = torch.from_numpy(_image(seed, shape))
        assert torch.equal(ring.upload(src), src)
    n_chunks = sum(-(-int(np.prod(s)) // SLOT) for s in shapes)
    assert _writes(ring) == [i % ring.n_slots for i in range(n_chunks)]
    by_slot = {}
    for what, k in ring.log:
        by_slot.setdefault(k, []).append(what)
    for k, seq in by_slot.items():
        assert seq == ["wait", "write", "record"] * (len(seq) // 3), k


@pytest.mark.parametrize("copiers", COPIERS)
def test_a_failed_copy_raises_and_leaves_no_copy_running(monkeypatch,
                                                         copiers):
    ring = _stand_in_ring(monkeypatch, SLOT, copiers, fail_at=4, slow_at=3)
    with pytest.raises(OSError, match="copy failed"):
        ring.upload(torch.from_numpy(_image(5)))
    assert all(j.done() for js in ring.jobs.values() for j in js)
    assert not ring._lock.locked()
    src = torch.from_numpy(_image(6))   # the ring still serves
    assert torch.equal(ring.upload(src), src)


@pytest.mark.parametrize("copiers", COPIERS)
def test_ring_uploads_float_and_flipped_bytes(monkeypatch, copiers):
    ring = _stand_in_ring(monkeypatch, SLOT, copiers)
    src = torch.from_numpy(_image(3).astype(np.float32))
    assert torch.equal(ring.upload(src), src)
    flipped = torch.from_numpy(_image(4).copy()).flip(0)
    got = ring.upload(flipped)
    assert got.is_contiguous() and torch.equal(got, flipped)


@pytest.mark.parametrize("copiers", [1, 2])
def test_threads_sharing_a_ring_never_share_a_slot(monkeypatch, copiers):
    """More uploading threads than the ring has slots, switching often:
    every upload arrives intact."""
    import sys
    import threading
    ring = _stand_in_ring(monkeypatch, SLOT, copiers)
    errors = []

    def worker(seed):
        try:
            for i in range(15):
                src = torch.from_numpy(_image(seed * 100 + i, (4, 9, 3)))
                if not torch.equal(ring.upload(src), src):
                    errors.append((seed, i))
        except Exception as exc:  # reported below
            errors.append(repr(exc))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
