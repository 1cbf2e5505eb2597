"""The port's prefetcher (bigdl_tpu_torch/dataset/prefetch.py), held to
the eight behaviours of the JAX package's tests/test_prefetch.py: order,
the producer-thread transform, the depth bound, a producer's exception
after its good items, close() (also while the producer is blocked on a
full queue), the timer, the context manager and BIGDL_TPU_PREFETCH_DEPTH.
Then the port's own: a CPU DevicePrefetcher hands the placed batch over
as it is, and to_device copies numpy arrays (and lists of them)."""
import threading
import time

import pytest

import numpy as np
import torch

from bigdl_tpu_torch.dataset.prefetch import (DevicePrefetcher, Prefetcher,
                                              prefetch_depth, to_device)


def test_order_preserved():
    p = Prefetcher(iter(range(100)), depth=4)
    assert list(p) == list(range(100))


def test_transform_runs_on_producer_thread():
    main = threading.current_thread().name
    seen = []

    def xf(x):
        seen.append(threading.current_thread().name)
        return x * 2

    p = Prefetcher(iter(range(5)), depth=2, transform=xf)
    assert list(p) == [0, 2, 4, 6, 8]
    assert seen and all(name != main for name in seen)


def test_depth_bounds_producer_runahead():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    p = Prefetcher(gen(), depth=3)
    time.sleep(0.2)  # consumer idle: producer must stall at the bound
    # queue(3) + the one item blocked in put + one being produced
    assert len(produced) <= 5
    assert next(p) == 0
    p.close()


def test_exception_propagates_after_good_items():
    def gen():
        yield from range(5)
        raise OSError("shard went away")

    p = Prefetcher(gen(), depth=2)
    got = []
    with pytest.raises(OSError, match="shard went away"):
        for item in p:
            got.append(item)
    assert got == list(range(5))


def test_close_stops_producer_thread():
    def gen():
        i = 0
        while True:  # infinite: only close() can stop it
            yield i
            i += 1

    p = Prefetcher(gen(), depth=2)
    assert next(p) == 0
    p.close()
    assert not p._t.is_alive()
    p.close()  # idempotent


def test_close_while_producer_blocked_on_full_queue():
    p = Prefetcher(iter(range(10_000)), depth=1)
    time.sleep(0.05)  # let the producer fill the queue and block
    p.close()
    assert not p._t.is_alive()


def test_timer_reports_production_time():
    times = []
    p = Prefetcher(
        iter(range(3)), depth=1,
        transform=lambda x: (time.sleep(0.01), x)[1],
        timer=times.append)
    assert list(p) == [0, 1, 2]
    assert len(times) == 3
    assert all(t >= 0.009 for t in times)


def test_context_manager_and_device_prefetcher_depth_env(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PREFETCH_DEPTH", "7")
    assert prefetch_depth() == 7
    monkeypatch.setenv("BIGDL_TPU_PREFETCH_DEPTH", "bogus")
    assert prefetch_depth() == 2
    monkeypatch.delenv("BIGDL_TPU_PREFETCH_DEPTH")
    with DevicePrefetcher(iter(range(4)), place=lambda b: b + 1) as p:
        assert list(p) == [1, 2, 3, 4]


def test_cpu_device_prefetcher_places_on_the_producer_thread():
    main = threading.current_thread().name
    seen = []

    def place(a):
        seen.append(threading.current_thread().name)
        return to_device(a, torch.device("cpu"), non_blocking=True)

    arrays = [np.full((2, 3), i, np.float32) for i in range(3)]
    with DevicePrefetcher(iter(arrays), place=place, depth=1,
                          device=torch.device("cpu")) as p:
        got = list(p)
    assert [float(t[0, 0]) for t in got] == [0.0, 1.0, 2.0]
    assert all(t.dtype == torch.float32 for t in got)
    assert seen and all(name != main for name in seen)
    pair = to_device([np.arange(3), np.ones((2,), np.float32)],
                     torch.device("cpu"))
    assert isinstance(pair, list) and pair[0].dtype == torch.int64
