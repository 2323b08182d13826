"""The port's transfer engines (``repro_torch.serve.transfer``) against the
reference's (``repro.serve.transfer``) under the same schedules.

``FakeTransferEngine``: the same virtual-clock script runs on both
engines; the stats ledgers (``TransferStats.as_dict()``: counters, stall
and hidden seconds of virtual time, per-tag sub-ledgers) must be equal,
the payloads equal to the host values at submit, and the errors (hung
link, timeout, double fence, fence after cancel) the same type and
message.  ``TransferEngine(device="cpu")``: the round trip, the loud
timeout (an event that never completes), cancel and drain, with the
counters equal to the reference's worker-pool engine on the same calls
(wall-clock seconds differ by nature and are only checked for sign).
The copy stream itself runs on the card (``chip_smoke.py`` phase 3).
"""

import numpy as np
import pytest
import torch

from repro.serve import transfer as JT
from repro_torch.serve import transfer as TT
from test_torch_threads import one_torch_thread  # noqa: F401


def _fake(mod, **kw):
    if mod is TT:
        kw["device"] = "cpu"
    return mod.FakeTransferEngine(**kw)


def _arr(mod, a):
    return torch.from_numpy(a) if mod is TT else a


def _blocked_fence(mod):
    eng = _fake(mod, latency_s=2.0)
    t = eng.submit("a", {"w": _arr(mod, np.ones(4, np.float32))})
    eng.advance(0.5)
    out = eng.fence(t)["w"]
    return eng, [out, eng.t]


def _ready_fence(mod):
    eng = _fake(mod, latency_s=1.0)
    t = eng.submit("a", {"w": _arr(mod, np.zeros(2, np.float32))})
    eng.advance(3.0)
    return eng, [eng.fence(t)["w"]]


def _out_of_order(mod):
    eng = _fake(mod, latency_s=10.0)
    a = eng.submit("a", {"w": _arr(mod, np.zeros(2, np.float32))})
    b = eng.submit("b", {"w": _arr(mod, np.ones(2, np.float32))},
                   tag="prefetch")
    eng.complete("b")
    ready = [eng.ready(b), eng.ready(a)]
    out = eng.fence(b)["w"]
    eng.advance(1.0)
    out2 = eng.fence(a)["w"]
    return eng, [ready, out, out2, eng.t]


def _hung(mod):
    eng = _fake(mod, schedule={"dead": None}, timeout_s=5.0)
    t = eng.submit("dead", {"w": _arr(mod, np.zeros(2, np.float32))})
    eng.advance(100.0)
    with pytest.raises(mod.TransferTimeout) as err:
        eng.fence(t)
    return eng, [str(err.value)]


def _slow(mod):
    eng = _fake(mod, schedule={"slow": 60.0}, timeout_s=5.0)
    t = eng.submit("slow", {"w": _arr(mod, np.zeros(2, np.float32))})
    with pytest.raises(mod.TransferTimeout) as err:
        eng.fence(t)
    return eng, [str(err.value)]


def _double_and_cancelled(mod):
    eng = _fake(mod)
    t = eng.submit("a", {"w": _arr(mod, np.zeros(2, np.float32))})
    eng.fence(t)
    with pytest.raises(RuntimeError) as double:
        eng.fence(t)
    c = eng.submit("b", {"w": _arr(mod, np.zeros(2, np.float32))},
                   tag="migrate")
    eng.cancel(c)
    eng.cancel(c)                      # idempotent
    with pytest.raises(RuntimeError) as cancelled:
        eng.fence(c)
    return eng, [str(double.value), str(cancelled.value)]


def _snapshot(mod):
    eng = _fake(mod, latency_s=1.0)
    w = np.ones(4, np.float32)
    t = eng.submit("a", {"w": _arr(mod, w)})
    w[:] = -7.0                        # mutate the host store after submit
    eng.advance(2.0)
    return eng, [eng.fence(t)["w"]]


def _waves(mod):
    eng = _fake(mod, wave_s=1.5, latency_s=2.0)
    t = eng.submit("a", {"w": _arr(mod, np.arange(3, dtype=np.float32))},
                   tag="demand")
    eng.on_wave()
    eng.on_wave(0.25)
    return eng, [eng.t, eng.fence(t)["w"], eng.t]


SCRIPTS = {"blocked_fence": _blocked_fence, "ready_fence": _ready_fence,
           "out_of_order": _out_of_order, "hung_link": _hung,
           "slow_link": _slow, "double_and_cancelled": _double_and_cancelled,
           "snapshot": _snapshot, "waves": _waves}


def _plain(v):
    if isinstance(v, torch.Tensor):
        return v.numpy().tolist()
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if hasattr(v, "shape"):
        return np.asarray(v).tolist()
    return v


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_fake_engine_matches_reference(script):
    want_eng, want = SCRIPTS[script](JT)
    got_eng, got = SCRIPTS[script](TT)
    assert got_eng.stats.as_dict() == want_eng.stats.as_dict()
    assert _plain(got) == _plain(want)


def test_fake_engine_materializes_on_its_device():
    eng = TT.FakeTransferEngine(device="cpu")
    out = eng.fence(eng.submit("a", {"w": torch.ones(3),
                                     "b": np.zeros(2, np.float32)}))
    assert out["w"].device.type == "cpu" and out["b"].dtype == torch.float32
    with pytest.raises(KeyError, match="no in-flight"):
        eng.complete("a")


def _counters(stats):
    """The ledger less what depends on timing (seconds, and whether a fence
    found its copy landed: on the CPU the port's copy is synchronous)."""
    d = stats.as_dict()
    return {k: v for k, v in d.items()
            if k not in ("stall_s", "hidden_s", "overlap_ratio", "tags",
                         "fences_ready", "fences_blocked")}


def test_real_engine_round_trip_matches_reference():
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    want = JT.TransferEngine(workers=2, timeout_s=10.0)
    got = TT.TransferEngine(device="cpu", timeout_s=10.0)
    assert got.stats.overlap_ratio == 1.0
    src = torch.from_numpy(w.copy())
    tw = want.submit("e0", {"w": w})
    tg = got.submit("e0", {"w": src})
    src[:] = -1.0                      # the copy was taken at submit
    assert got.ready(tg)
    np.testing.assert_array_equal(got.fence(tg)["w"].numpy(),
                                  np.asarray(want.fence(tw)["w"]))
    assert got.ready(tg)               # fenced: done
    assert _counters(got.stats) == _counters(want.stats)
    assert got.stats.bytes_submitted == w.nbytes
    assert got.stats.stall_s >= 0.0 and got.stats.hidden_s >= 0.0
    assert set(got.stats.tags) == {"page"}
    with pytest.raises(RuntimeError, match="double fence"):
        got.fence(tg)


class _NeverLands:
    @staticmethod
    def query():
        return False


def test_real_engine_fence_timeout_is_loud():
    """A copy whose event never completes raises TransferTimeout naming
    its key (the reference's unresolved future), instead of hanging."""
    eng = TT.TransferEngine(device="cpu", timeout_s=0.05)
    t = eng.submit("stuck", {"w": torch.zeros(2)})
    t._event = _NeverLands()
    assert not eng.ready(t)
    with pytest.raises(TT.TransferTimeout, match="stuck"):
        eng.fence(t)
    assert eng.stats.timeouts == 1 and eng.stats.fenced == 0


def test_real_engine_cancel_then_drain_matches_reference():
    want, got = JT.TransferEngine(), TT.TransferEngine(device="cpu")
    tw = want.submit("a", {"w": np.zeros(8, np.float32)})
    tg = got.submit("a", {"w": torch.zeros(8)})
    for eng, t in ((want, tw), (got, tg)):
        eng.cancel(t)
        eng.cancel(t)                  # idempotent
        eng.drain()
    with pytest.raises(RuntimeError, match="cancelled"):
        got.fence(tg)
    assert not got.ready(tg)
    w2 = want.submit("b", {"w": np.ones(2, np.float32)})
    g2 = got.submit("b", {"w": torch.ones(2)}, tag="prefetch")
    np.testing.assert_array_equal(got.fence(g2)["w"].numpy(),
                                  np.asarray(want.fence(w2)["w"]))
    assert _counters(got.stats) == _counters(want.stats)
    assert got.stats.bytes_cancelled == 32
    assert got.stats.fences_ready == got.stats.fenced == 1
    got.reset_stats()
    assert got.stats.as_dict() == TT.TransferStats().as_dict()
