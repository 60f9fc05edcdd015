"""The port's Dispatcher (mlsl_tpu_torch.comm.request) against the JAX
package's: newest-first deferral with autonomous progress.

- The launch order of deferred requests under MLSL_MSG_PRIORITY_MODE 1
  (LIFO) and 0 (FIFO) equals ``mlsl_tpu.comm.request.Dispatcher``'s on the
  same start sequence, small messages going at once in both.
- A deferred request launches with no wait or test: the progress thread
  flushes it ``msg_priority_flush_ms`` after the deferral. The test polls
  with a 5 s deadline and asserts the launch, not its timing.
- A dispatch that fails on the progress thread stays on its request: that
  request's wait raises it, the thread lives on and the next request works.
- ``Environment.finalize`` launches what is deferred and stops the thread.

Each test runs under its own time limit (SIGALRM), so a hang fails fast.
"""

import signal
import time

import numpy as np
import pytest
import torch

from mlsl_tpu.comm.request import Dispatcher as JDispatcher
from mlsl_tpu.config import Config as JConfig
from mlsl_tpu_torch.comm.request import CommDesc, CommRequest, Dispatcher as TDispatcher
from mlsl_tpu_torch.config import Config as TConfig
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.types import DataType, GroupType, ReductionType

torch.set_num_threads(2)

LIMIT_S = 30


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class _Desc:
    def __init__(self, nbytes):
        self.kind = "allreduce"
        self.nbytes = nbytes

    def payload_bytes(self):
        return self.nbytes


class _FakeReq:
    """The request surface both dispatchers read; ``_dispatch`` records."""

    def __init__(self, uid, nbytes, order):
        self.uid = uid
        self.name = f"r{uid}"
        self._trace_name = self.name
        self.desc = _Desc(nbytes)
        self._payload = nbytes
        self._epoch = 1
        self._order = order

    def _dispatch(self, buf, epoch=None):
        self._order.append(self.uid)


SIZES = [64, 8, 128, 4096, 32, 64, 12, 1 << 20]


def _launch_order(dispatcher_cls, config):
    order = []
    d = dispatcher_cls(config)
    try:
        for uid, nbytes in enumerate(SIZES, start=1):
            d.submit(_FakeReq(uid, nbytes, order), None)
        d.flush()
    finally:
        d.shutdown()
    return order


@pytest.mark.parametrize("mode", [1, 0])
def test_launch_order_matches_jax(mode):
    configs = []
    for cls in (JConfig, TConfig):
        c = cls()
        c.msg_priority = True
        c.msg_priority_threshold = 16
        c.msg_priority_mode = bool(mode)
        c.msg_priority_flush_ms = 600_000.0   # the test flushes, not the thread
        configs.append(c)
    want = _launch_order(JDispatcher, configs[0])
    got = _launch_order(TDispatcher, configs[1])
    small = [u for u, n in enumerate(SIZES, start=1) if n <= 16]
    deferred = [u for u, n in enumerate(SIZES, start=1) if n > 16]
    assert got == want == small + (deferred[::-1] if mode else deferred)


def test_knobs_read_the_environment(monkeypatch):
    monkeypatch.setenv("MLSL_MSG_PRIORITY_MODE", "0")
    monkeypatch.setenv("MLSL_MSG_PRIORITY_FLUSH_MS", "7.5")
    monkeypatch.setenv("MLSL_OVERLAP_STAGES", "3")
    t, j = TConfig.from_env(), JConfig.from_env()
    assert (t.msg_priority_mode, t.msg_priority_flush_ms, t.overlap_stages) == (False, 7.5, 3)
    assert (j.msg_priority_mode, j.msg_priority_flush_ms, j.overlap_stages) == (False, 7.5, 3)
    d = TConfig()
    assert (d.msg_priority_mode, d.msg_priority_flush_ms, d.overlap_stages) == (
        JConfig().msg_priority_mode, JConfig().msg_priority_flush_ms, 2)


@pytest.fixture()
def deferring_env(monkeypatch):
    monkeypatch.setenv("MLSL_MSG_PRIORITY", "1")
    monkeypatch.setenv("MLSL_MSG_PRIORITY_THRESHOLD", "16")
    monkeypatch.setenv("MLSL_MSG_PRIORITY_FLUSH_MS", "2")
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _started(env, td, count=64):
    buf = td.make_buffer(lambda p: np.full(count, p + 1, np.float32), count)
    return td.all_reduce(buf, count, DataType.FLOAT, ReductionType.SUM, GroupType.DATA)


def _poll(cond, deadline_s=5.0):
    end = time.monotonic() + deadline_s
    while not cond() and time.monotonic() < end:
        time.sleep(0.001)
    return cond()


def test_deferred_request_launches_unprompted(deferring_env):
    td = deferring_env.create_distribution(8, 1)
    req = _started(deferring_env, td)
    assert _poll(lambda: req._dispatched), "the progress thread never launched the request"
    assert deferring_env.dispatcher.pending_count == 0
    out = req.wait()
    np.testing.assert_array_equal(td.local_part(out, 5), np.full(64, 36.0, np.float32))


def test_dispatch_error_stays_on_its_request(deferring_env):
    td = deferring_env.create_distribution(8, 1)
    bad = CommRequest(CommDesc("allreduce", td.data_group, 64, DataType.FLOAT,
                               op=ReductionType.SUM), deferring_env.dispatcher, name="bad")
    bad.setup()

    def broken(buf):
        raise RuntimeError("injected dispatch failure")

    bad._run = broken
    buf = td.make_buffer(lambda p: np.ones(64, np.float32), 64)
    bad.start(buf)
    assert _poll(lambda: bad._dispatched)
    with pytest.raises(RuntimeError, match="injected"):
        bad.wait()
    assert deferring_env.dispatcher._thread.is_alive()
    good = _started(deferring_env, td)
    assert _poll(lambda: good._dispatched)
    np.testing.assert_array_equal(td.local_part(good.wait(), 0), np.full(64, 36.0))


def test_finalize_stops_the_thread(deferring_env):
    td = deferring_env.create_distribution(8, 1)
    deferring_env.dispatcher.config.msg_priority_flush_ms = 600_000.0
    req = _started(deferring_env, td)
    d = deferring_env.dispatcher
    thread = d._thread
    assert thread is not None and thread.is_alive() and not req._dispatched
    deferring_env.finalize()
    assert req._dispatched            # finalize launched the deferred request
    assert not thread.is_alive() and d._thread is None
