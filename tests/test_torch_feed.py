"""The port's device feed (mlsl_tpu_torch.data, DataParallelTrainer.feed)
against the JAX package's (mlsl_tpu.data), after tests/test_feed.py.

The same seeded numpy batches go through both packages: the JAX side on the
8-device CPU mesh, the port with ``device="cpu"`` (8 virtual ranks).

- Decodes are bit for bit: uint8 raw and affine (and their host math), int8
  (the port's B2 plain version against JAX's dequantize), bf16 (torch's
  round-to-nearest-even cast against ml_dtypes'), labels untouched; wire and
  full byte counts equal.
- Cache and epochs: the decoded stream with the cache on and off, shuffled,
  equals JAX's bit for bit, and the FEED counters equal JAX's.
- The trainer: ``trainer.feed`` lands on the bit-identical parameters of
  ``shard_batch`` on the port, and within 1e-6 of JAX's ``trainer.feed`` run.
- The loader's contracts (backpressure, stalls, worker death, TRANSIENT
  retries, dead generators, ``place`` refused over a DeviceFeed) and the
  FEED line of ``mlsl_stats.log``.

The JAX tests of the chaos sites, the bitrot trigger and the tracer spans are
not ported (those subsystems are not in the port yet).
"""

import time

import jax
import numpy as np
import pytest
import torch

from mlsl_tpu.core import stats as jstats
from mlsl_tpu.data import DeviceFeed as JFeed, FeedCodec as JCodec
from mlsl_tpu.data.common import parse_wire_spec as jparse
from mlsl_tpu.log import MLSLError as JMLSLError
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.core import stats as tstats
from mlsl_tpu_torch.core.environment import Environment
from mlsl_tpu_torch.data import AsyncLoader, DeviceFeed, FeedCodec, parse_wire_spec
from mlsl_tpu_torch.log import MLSLError

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_feed_state():
    tstats.reset_feed_counters()
    jstats.reset_feed_counters()
    yield
    tstats.reset_feed_counters()
    jstats.reset_feed_counters()


@pytest.fixture()
def tenv():
    e = Environment.get_env().init(device="cpu", world_size=8)
    yield e
    e.finalize()


def _topos(env, tenv, n=8):
    return env.create_distribution(n, 1).topology, tenv.create_distribution(n, 1).topology


def _batches(k=4, b=16, shape=(8,), classes=4, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, *shape)).astype(dtype),
             rng.integers(0, classes, size=(b,)).astype(np.int32)) for _ in range(k)]


def _host(buf):
    """Distributed buffer (R, D, S, M, localB, ...) of either package -> the
    host batch (B, ...) from the (s, m) = (0, 0) copies."""
    a = buf.numpy() if isinstance(buf, torch.Tensor) else np.asarray(buf)
    return np.ascontiguousarray(a[:, :, 0, 0]).reshape(-1, *a.shape[5:])


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# -- wire-spec grammar and config --------------------------------------------------


SPECS = [None, "", "f32", "uint8", "bfloat16", "uint8,y=none", "x=int8", "img.raw=u8",
         "i8,x=bf16,y=off"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_wire_spec_matches_jax(spec):
    assert parse_wire_spec(spec) == jparse(spec)


def test_parse_wire_spec_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown feed wire dtype"):
        parse_wire_spec("float8")
    with pytest.raises(ValueError, match="unknown feed wire dtype"):
        jparse("float8")


def test_leaf_override_aliases_and_dict_keys(env, tenv):
    """x/y alias the (x, y) tuple's positional leaves at lookup; a dict leaf
    literally named 'x' matches its own name: both packages pick the same
    kinds for every leaf."""
    jtopo, ttopo = _topos(env, tenv)
    rng = np.random.default_rng(17)
    xf = rng.normal(size=(16, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(16,)).astype(np.int32)
    cases = [("x=uint8", (xf, y)), ("x=bf16,y=none", {"x": xf, "y": y}),
             ("int8,y=uint8", {"img": {"raw": xf}, "y": y})]
    for spec, batch in cases:
        jc, tc = JCodec(jtopo, spec), FeedCodec(ttopo, spec)
        jc.stage(batch)
        tc.stage(batch)
        assert [(l.key, l.kind) for l in tc._layout] == [(l.key, l.kind) for l in jc._layout]
    assert [l.kind for l in tc._layout] == ["int8", "none"]


def test_config_validates_feed_knobs(monkeypatch):
    c = Config()
    assert (c.feed_wire_dtype, c.feed_cache_mb, c.feed_depth, c.feed_retries) == ("", 0, 2, 2)
    c.feed_wire_dtype = "uint8,y=none"
    c.validate()
    c.feed_wire_dtype = "garbage"
    with pytest.raises(MLSLError, match="MLSL_FEED_WIRE_DTYPE"):
        c.validate()
    for field, env_name in (("feed_depth", "MLSL_FEED_DEPTH"),
                            ("feed_cache_mb", "MLSL_FEED_CACHE_MB"),
                            ("feed_retries", "MLSL_FEED_RETRIES")):
        c = Config()
        setattr(c, field, 0 if field == "feed_depth" else -1)
        with pytest.raises(MLSLError, match=env_name):
            c.validate()
    monkeypatch.setenv("MLSL_FEED_WIRE_DTYPE", "int8")
    monkeypatch.setenv("MLSL_FEED_CACHE_MB", "64")
    monkeypatch.setenv("MLSL_FEED_DEPTH", "3")
    monkeypatch.setenv("MLSL_FEED_RETRIES", "5")
    c = Config.from_env()
    assert (c.feed_wire_dtype, c.feed_cache_mb, c.feed_depth, c.feed_retries) == \
        ("int8", 64, 3, 5)
    assert {"feed_wire_dtype", "feed_cache_mb", "feed_depth"} <= c._explicit


def test_profile_feed_depth_knob(monkeypatch):
    """A tuned profile's feed_depth applies unless MLSL_FEED_DEPTH is exported."""
    from mlsl_tpu_torch.tuner import TUNABLE_KNOBS, apply_knobs
    from mlsl_tpu_torch.tuner.profile import TunedProfile

    assert "feed_depth" in TUNABLE_KNOBS
    prof = TunedProfile(fingerprint={}, knobs={"feed_depth": 4})
    c = Config.from_env()
    apply_knobs(c, prof)
    assert c.feed_depth == 4
    monkeypatch.setenv("MLSL_FEED_DEPTH", "3")
    c = Config.from_env()
    apply_knobs(c, prof)
    assert c.feed_depth == 3


# -- decode parity against JAX ---------------------------------------------------------


def test_uint8_raw_decode_parity_bitexact(env, tenv):
    """A uint8 leaf ships raw; cast + normalize on the device equals JAX's
    decode and the host float32 math bit for bit."""
    jtopo, ttopo = _topos(env, tenv)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(16, 4, 3)).astype(np.uint8)
    y = rng.integers(0, 4, size=(16,)).astype(np.int32)
    mean = np.array([125.3, 122.9, 113.8], np.float32)
    std = np.array([63.0, 62.1, 66.7], np.float32)
    jc = JCodec(jtopo, "uint8", normalize=(mean, std))
    jw, jwb, jfb = jc.stage((x, y))
    tc = FeedCodec(ttopo, "uint8", normalize=(mean, std))
    tw, twb, tfb = tc.stage((x, y))
    dx, dy = tc.decode(tw)
    jx, jy = jc.decode(jw)
    ref = (x.astype(np.float32) - mean) * (np.float32(1.0) / std)
    _same_bits(_host(dx), ref)
    _same_bits(_host(dx), _host(jx))
    _same_bits(_host(dy), y)
    assert dx.shape == tuple(np.asarray(jx).shape) and dx.dtype == torch.float32
    assert (twb, tfb) == (jwb, jfb)
    assert twb < (x.size * 4 + y.nbytes) / 3.0


def test_uint8_affine_decode_parity(env, tenv):
    """A float leaf on the uint8 wire: (q + off) * scale per shard, bit for bit
    against JAX's decode and the host math, within scale/2 of the input."""
    from mlsl_tpu_torch.data.wire import _encode_uint8

    jtopo, ttopo = _topos(env, tenv)
    (x, y), = _batches(1, 16, (8, 3), seed=1)
    tc, jc = FeedCodec(ttopo, "uint8"), JCodec(jtopo, "uint8")
    tw, twb, tfb = tc.stage((x, y))
    jw, jwb, jfb = jc.stage((x, y))
    assert (twb, tfb) == (jwb, jfb) and twb < tfb / 3.0
    got = _host(tc.decode(tw)[0])
    _same_bits(got, _host(jc.decode(jw)[0]))
    worst = 0.0
    for d in range(8):
        q, meta = _encode_uint8(x[d * 2:(d + 1) * 2])
        _same_bits(got[d * 2:(d + 1) * 2], (q.astype(np.float32) + meta[0]) * meta[1])
        worst = max(worst, float(meta[1]))
    assert np.abs(got - x).max() <= worst * 0.51 + 1e-6


@pytest.mark.parametrize("block", [128, 256])
def test_int8_block_codec_parity(env, tenv, block):
    """The int8 wire: the payload (padded to block x 32 a shard, the JAX
    package's tile) and its scales equal JAX's, the decode (B2's plain version)
    equals JAX's dequantize bit for bit, and labels ride unchanged."""
    jtopo, ttopo = _topos(env, tenv)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    y = rng.integers(0, 4, size=(16,)).astype(np.int32)
    tc = FeedCodec(ttopo, "int8", quant_block=block)
    jc = JCodec(jtopo, "int8", quant_block=block)
    tw, twb, tfb = tc.stage((x, y))
    jw, jwb, jfb = jc.stage((x, y))
    assert (twb, tfb) == (jwb, jfb)
    np.testing.assert_array_equal(tw.leaves[0]["q"].numpy(),
                                  np.asarray(jw[0]["q"])[:, :, 0, 0])
    _same_bits(tw.leaves[0]["s"].numpy(), np.asarray(jw[0]["s"])[:, :, 0, 0])
    dx, dy = tc.decode(tw)
    jx, _ = jc.decode(jw)
    _same_bits(_host(dx), _host(jx))
    assert np.abs(_host(dx) - x).max() <= np.abs(x).max() / 127.0
    _same_bits(_host(dy), y)


def test_int8_block_refused_at_construction(tenv):
    """A block B2 cannot take is refused when the codec is built."""
    ttopo = tenv.create_distribution(8, 1).topology
    for block in (0, 48, 100):
        with pytest.raises(MLSLError, match="multiple of 32"):
            FeedCodec(ttopo, "int8", quant_block=block)


def test_uint8_affine_rejects_extreme_dc_offset(env, tenv):
    jtopo, ttopo = _topos(env, tenv)
    x = (1e7 + np.linspace(0, 1, 16 * 8).reshape(16, 8)).astype(np.float32)
    y = np.zeros((16,), np.int32)
    with pytest.raises(MLSLError, match="DC offset"):
        FeedCodec(ttopo, "uint8").stage((x, y))
    with pytest.raises(JMLSLError, match="DC offset"):
        JCodec(jtopo, "uint8").stage((x, y))


def test_bf16_wire_and_labels_untouched(env, tenv):
    """torch's host bf16 cast rounds as ml_dtypes does: the decoded batch
    equals JAX's bit for bit (ties and subnormals included)."""
    jtopo, ttopo = _topos(env, tenv)
    (x, y), = _batches(1, 16, (8,), seed=3)
    # exact ties of the bf16 rounding, a subnormal and both zeros
    x[0, :4] = np.array([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1e-40, -0.0], np.float32)
    tc, jc = FeedCodec(ttopo, "bf16"), JCodec(jtopo, "bf16")
    tw, twb, tfb = tc.stage((x, y))
    jw, jwb, jfb = jc.stage((x, y))
    assert tw.leaves[0]["q"].dtype == torch.bfloat16
    dx, dy = tc.decode(tw)
    jx, jy = jc.decode(jw)
    _same_bits(_host(dx), _host(jx))
    _same_bits(_host(dx), np.asarray(x.astype(jax.numpy.bfloat16).astype(np.float32)))
    _same_bits(_host(dy), y)
    assert twb == jwb == x.size * 2 + y.nbytes and tfb == jfb


# -- cache and epochs ---------------------------------------------------------------


def _stream(feed):
    return [tuple(_host(l) for l in b) for b in feed]


@pytest.mark.parametrize("cache_mb", [64, 0])
def test_cache_epoch_parity_fixed_shuffle(env, tenv, cache_mb):
    """Cache on and off under a fixed shuffle seed: the port's decoded stream
    equals JAX's bit for bit, and the counters agree (the cached run stages
    each batch once)."""
    jtopo, ttopo = _topos(env, tenv)
    batches = _batches(4, 16, (8,), seed=4)
    got = _stream(DeviceFeed(batches, ttopo, wire="uint8", cache_mb=cache_mb, epochs=3,
                             shuffle_seed=11))
    want = _stream(JFeed(batches, jtopo, wire="uint8", cache_mb=cache_mb, epochs=3,
                         shuffle_seed=11))
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        for la, lb in zip(a, b):
            _same_bits(la, lb)
    for k in ("batches_staged", "wire_bytes", "bytes_saved", "cache_hits",
              "cache_misses", "cache_rejects"):
        assert tstats.FEED_COUNTERS[k] == jstats.FEED_COUNTERS[k], k
    staged, hits = (4, 8) if cache_mb else (12, 0)
    assert tstats.FEED_COUNTERS["batches_staged"] == staged
    assert tstats.FEED_COUNTERS["cache_hits"] == hits
    assert any(not np.array_equal(got[e * 4][0], batches[0][0]) for e in range(3))


def test_cache_budget_rejects_but_streams(env, tenv):
    jtopo, ttopo = _topos(env, tenv)
    batches = _batches(3, 16, (64,), seed=5)
    feed = DeviceFeed(batches, ttopo, wire="none", cache_mb=0.004, epochs=2)
    out = list(feed)
    jfeed = JFeed(batches, jtopo, wire="none", cache_mb=0.004, epochs=2)
    list(jfeed)
    assert len(out) == 6
    assert feed.cache.rejects == jfeed.cache.rejects > 0
    assert feed.cache.bytes == jfeed.cache.bytes
    assert tstats.FEED_COUNTERS["cache_rejects"] == jstats.FEED_COUNTERS["cache_rejects"] > 0
    assert tstats.FEED_COUNTERS["batches_staged"] >= 4


def test_cached_batch_decodes_stably(tenv):
    """Cache hits decode without donating: the cached wire batch survives
    every replay, and a donated one is refused a second decode."""
    ttopo = tenv.create_distribution(8, 1).topology
    batches = _batches(1, 16, (8,), seed=6)
    feed = DeviceFeed(batches, ttopo, wire="uint8", cache_mb=64, epochs=4)
    outs = [_host(b[0]) for b in feed]
    for o in outs[1:]:
        _same_bits(outs[0], o)
    assert feed.cache._slots[0].leaves is not None
    codec = FeedCodec(ttopo, "uint8")
    wire, _, _ = codec.stage(batches[0])
    codec.decode(wire, donate=True)
    assert wire.leaves is None
    with pytest.raises(MLSLError, match="donated"):
        codec.decode(wire)


def test_one_shot_iterator_replay_contract(tenv):
    ttopo = tenv.create_distribution(8, 1).topology
    batches = _batches(3, 16, (8,), seed=7)
    feed = DeviceFeed(iter(batches), ttopo, wire="bf16", cache_mb=64, epochs=2)
    assert len(list(feed)) == 6
    assert feed.cache_complete
    feed = DeviceFeed(iter(batches), ttopo, wire="bf16", cache_mb=0, epochs=2)
    with pytest.raises(MLSLError, match="one-shot iterator"):
        list(feed)
    with pytest.raises(MLSLError, match="sequence source"):
        DeviceFeed(iter(batches), ttopo, shuffle_seed=1)


def test_factory_source_replays_from_cache(tenv):
    """A factory source is read once while the cache fills; afterwards the
    feed serves every epoch from the card."""
    ttopo = tenv.create_distribution(8, 1).topology
    batches = _batches(2, 16, (8,), seed=21)
    calls = {"n": 0}

    def factory():
        calls["n"] += 1
        return iter(batches)

    feed = DeviceFeed(factory, ttopo, wire="uint8", cache_mb=64, epochs=3)
    out = _stream(feed)
    assert len(out) == 6 and calls["n"] == 1
    _same_bits(out[0][0], out[2][0])


def test_sources_match_jax(tmp_path):
    """file_source and synthetic_source yield JAX's batches."""
    from mlsl_tpu.data import file_source as jfile, synthetic_source as jsyn
    from mlsl_tpu_torch.data import file_source, synthetic_source

    for a, b in zip(synthetic_source(8, (4, 3), 10, seed=3, steps=3),
                    jsyn(8, (4, 3), 10, seed=3, steps=3)):
        for la, lb in zip(a, b):
            _same_bits(la, lb)
    paths = []
    for i, (x, y) in enumerate(_batches(2, 16, (8,), seed=22)):
        p = tmp_path / f"b{i}.npz"
        np.savez(p, x=x, y=y)
        paths.append(p)
    got, want = list(file_source(iter(paths), epochs=2)), list(jfile(paths, epochs=2))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for la, lb in zip(a, b):
            _same_bits(la, lb)


# -- the trainer ------------------------------------------------------------------


def _twins(env, tenv):
    from mlsl_tpu.models.mlp import LAYERS, get_layer, init, loss_fn
    from mlsl_tpu.models.train import DataParallelTrainer as JTrainer
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.convert import params_from_jax
    from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer

    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))

    def jbuild():
        dist = env.create_distribution(8, 1)
        sess = env.create_session()
        sess.set_global_minibatch_size(16)
        return JTrainer(env, dist, sess, params, loss_fn, LAYERS, get_layer,
                        donate_params=False)

    def tbuild():
        dist = tenv.create_distribution(8, 1)
        sess = tenv.create_session()
        sess.set_global_minibatch_size(16)
        model = tmlp.MLP(device="cpu", params=params_from_jax(params, device="cpu"))
        return TTrainer(tenv, dist, sess, model, tmlp.loss_fn, tmlp.LAYERS, tmlp.get_layer)

    return jbuild, tbuild


def _params(tr):
    from mlsl_tpu_torch.models.convert import params_to_jax

    return [np.asarray(l) for l in jax.tree.leaves(params_to_jax(tr.model))]


@pytest.mark.parametrize("wire", ["", "uint8"])
def test_trainer_feed_matches_shard_batch_and_jax(env, tenv, wire):
    """trainer.feed lands on the bit-identical parameters of shard_batch fed
    the host-decoded batches, and within 1e-6 of JAX's trainer.feed."""
    jbuild, tbuild = _twins(env, tenv)
    batches = _batches(3, 16, (8,), seed=8)
    tr1 = tbuild()
    loader = tr1.feed(batches, wire=wire, cache_mb=0, epochs=2)
    losses = [tr1.step(b) for b in loader]
    loader.close()
    assert len(losses) == 6
    codec = FeedCodec(tr1.dist.topology, wire)
    decoded = [tuple(_host(l) for l in codec.decode(codec.stage(b)[0])) for b in batches]
    tr2 = tbuild()
    for _ in range(2):
        for x, y in decoded:
            tr2.step(tr2.shard_batch(x, y))
    for a, b in zip(_params(tr1), _params(tr2)):
        _same_bits(a, b)
    jt = jbuild()
    jloader = jt.feed(batches, wire=wire, cache_mb=0, epochs=2)
    jlosses = [np.asarray(jt.step(b)) for b in jloader]
    jloader.close()
    for a, b in zip(losses, jlosses):
        np.testing.assert_allclose(a.numpy().reshape(-1), b.reshape(-1), rtol=1e-6, atol=1e-7)
    for a, b in zip(_params(tr1), [np.asarray(l) for l in jax.tree.leaves(jt.params)]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_trainer_feed_uint8_cache_trains(tenv):
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer

    dist = tenv.create_distribution(8, 1)
    sess = tenv.create_session()
    sess.set_global_minibatch_size(16)
    tr = TTrainer(tenv, dist, sess, tmlp.MLP(device="cpu"), tmlp.loss_fn, tmlp.LAYERS,
                  tmlp.get_layer)
    loader = tr.feed(_batches(2, 16, (8,), seed=9), wire="uint8", cache_mb=64, epochs=3,
                     shuffle_seed=3)
    losses = [float(tr.step(b).reshape(-1)[0]) for b in loader]
    st = loader.stats()
    loader.close()
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert tstats.FEED_COUNTERS["cache_hits"] == 4
    assert tstats.FEED_COUNTERS["batches_staged"] == 2
    assert st["consumed"] == 6 and st["depth"] == 2


def test_trainer_feed_takes_config_defaults(tenv):
    """trainer.feed reads the Config's feed knobs and the trainer's device;
    shard_batch_local is shard_batch in a one-process world."""
    from mlsl_tpu_torch.models import mlp as tmlp
    from mlsl_tpu_torch.models.train import DataParallelTrainer as TTrainer

    tenv.config.feed_wire_dtype = "bf16"
    tenv.config.feed_depth = 3
    tenv.config.feed_cache_mb = 64
    dist = tenv.create_distribution(8, 1)
    sess = tenv.create_session()
    sess.set_global_minibatch_size(16)
    tr = TTrainer(tenv, dist, sess, tmlp.MLP(device="cpu"), tmlp.loss_fn, tmlp.LAYERS,
                  tmlp.get_layer)
    batches = _batches(2, 16, (8,), seed=23)
    loader = tr.feed(batches, epochs=2)
    out = list(loader)
    st = loader.stats()
    loader.close()
    assert st["depth"] == 3 and len(out) == 4
    assert tstats.FEED_COUNTERS["cache_hits"] == 2
    _same_bits(_host(out[0][0]), batches[0][0].astype(jax.numpy.bfloat16).astype(np.float32))
    x, y = batches[0]
    for a, b in zip(tr.shard_batch_local(x, y), tr.shard_batch(x, y)):
        _same_bits(a.numpy(), b.numpy())


# -- the loader's contracts ------------------------------------------------------------


def test_backpressure_and_stall_accounting():
    def slow_source():
        for i in range(3):
            time.sleep(0.05)
            yield np.full((4,), i, np.float32)

    loader = AsyncLoader(slow_source(), place=lambda b: b, depth=2)
    got = list(loader)
    st = loader.stats()
    loader.close()
    assert len(got) == 3
    assert st["stall_ms"] > 0 and tstats.FEED_COUNTERS["stall_ms"] > 0

    def fast_source():
        for i in range(6):
            yield np.full((4,), i, np.float32)

    loader = AsyncLoader(fast_source(), place=lambda b: b, depth=1)
    time.sleep(0.2)  # the worker fills the queue and blocks
    assert loader.stats()["in_flight"] <= 1
    out = list(loader)
    assert [int(o[0]) for o in out] == list(range(6))
    assert loader.stats()["producer_wait_ms"] > 0
    loader.close()


def test_worker_death_surfaces_original_exception():
    def dying_source():
        yield np.zeros((4,), np.float32)
        yield np.ones((4,), np.float32)
        raise KeyError("backing store lost the shard")

    loader = AsyncLoader(dying_source(), place=lambda b: b, depth=2)
    it = iter(loader)
    assert next(it) is not None
    assert next(it) is not None
    with pytest.raises(KeyError, match="backing store"):
        next(it)
    with pytest.raises(KeyError, match="backing store"):
        next(it)
    loader.close()


def test_transient_source_errors_retry():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] in (2, 3):
            raise OSError("nfs hiccup")  # TRANSIENT in the taxonomy
        if calls["n"] > 5:
            raise StopIteration
        return np.full((4,), calls["n"], np.float32)

    loader = AsyncLoader(flaky, place=lambda b: b, depth=1, retries=2,
                         retry_backoff_s=0.001)
    got = list(loader)
    loader.close()
    assert [int(g[0]) for g in got] == [1, 4, 5]
    assert tstats.FEED_COUNTERS["retries"] == 2

    def always_bad():
        raise OSError("disk gone")

    loader = AsyncLoader(always_bad, place=lambda b: b, depth=1, retries=1,
                         retry_backoff_s=0.001)
    with pytest.raises(OSError, match="disk gone"):
        next(iter(loader))
    loader.close()

    def fatal():
        raise ValueError("caller bug")  # FATAL: never retried

    tstats.reset_feed_counters()
    loader = AsyncLoader(fatal, place=lambda b: b, depth=1, retries=3,
                         retry_backoff_s=0.001)
    with pytest.raises(ValueError, match="caller bug"):
        next(iter(loader))
    loader.close()
    assert tstats.FEED_COUNTERS["retries"] == 0


EXCEPTIONS = [OSError("x"), TimeoutError("x"), ConnectionResetError("x"), ValueError("x"),
              MemoryError(), FloatingPointError("x"), RuntimeError("x"), KeyError("x")]


@pytest.mark.parametrize("exc", EXCEPTIONS, ids=lambda e: type(e).__name__)
def test_taxonomy_matches_jax(exc):
    from mlsl_tpu import supervisor as jsup
    from mlsl_tpu_torch import supervisor as tsup

    assert tsup.classify(exc).value == jsup.classify(exc).value


def test_taxonomy_of_the_error_hierarchy():
    from mlsl_tpu_torch import log, supervisor as tsup

    E = tsup.ErrorClass
    assert tsup.classify(log.MLSLCorruptionError("x")) is E.CORRUPTION
    assert tsup.classify(log.MLSLIntegrityError("x")) is E.CORRUPTION
    assert tsup.classify(log.MLSLDeviceLossError("x")) is E.DEVICE_LOSS
    assert tsup.classify(log.MLSLTimeoutError("x")) is E.PERSISTENT
    assert tsup.classify(MLSLError("x")) is E.PERSISTENT


def test_dead_generator_error_surfaces_not_truncates(tenv):
    def gen():
        yield np.zeros((4,), np.float32)
        yield np.ones((4,), np.float32)
        raise OSError("nfs hiccup")  # TRANSIENT, but the frame is dead

    loader = AsyncLoader(gen(), place=lambda b: b, depth=1, retries=3,
                         retry_backoff_s=0.001)
    it = iter(loader)
    assert len([next(it), next(it)]) == 2
    with pytest.raises(OSError, match="nfs hiccup"):
        next(it)
    loader.close()

    ttopo = tenv.create_distribution(8, 1).topology
    good = _batches(1, 16, (8,), seed=18)[0]

    def factory():
        def g():
            yield good
            raise OSError("read failed")
        return g()

    feed = DeviceFeed(factory, ttopo, wire="none", cache_mb=0, retries=3)
    it = iter(feed)
    assert next(it) is not None
    with pytest.raises(OSError, match="read failed"):
        next(it)
    assert feed._n is None  # the epoch length is not learned from a dead stream


def test_loader_surfaces_feed_error_not_truncation(tenv):
    ttopo = tenv.create_distribution(8, 1).topology
    good = _batches(1, 16, (8,), seed=16)[0]

    def source():
        yield good
        raise OSError("source died")

    loader = AsyncLoader(DeviceFeed(source(), ttopo, wire="none", cache_mb=0, retries=0),
                         depth=2)
    it = iter(loader)
    assert next(it) is not None
    with pytest.raises(OSError, match="source died"):
        next(it)
    loader.close()


def test_sequence_feed_retries_transient_reads(tenv):
    """A sequence source's read is attempted again on a TRANSIENT error."""
    ttopo = tenv.create_distribution(8, 1).topology
    batches = _batches(2, 16, (8,), seed=24)
    fails = {"n": 0}

    class Flaky(list):
        def __getitem__(self, i):
            if fails["n"] < 1:
                fails["n"] += 1
                raise ConnectionResetError("reset")
            return list.__getitem__(self, i)

    feed = DeviceFeed(Flaky(batches), ttopo, wire="none", retries=2)
    assert len(list(feed)) == 2
    assert tstats.FEED_COUNTERS["retries"] == 1


def test_loader_rejects_place_with_devicefeed(tenv):
    ttopo = tenv.create_distribution(8, 1).topology
    feed = DeviceFeed(_batches(1, 16, (8,), seed=20), ttopo, wire="none")
    with pytest.raises(MLSLError, match="place must be None"):
        AsyncLoader(feed, lambda x, y: (x, y), depth=1)


def test_loader_over_devicefeed_matches_the_feed(tenv):
    """The loader's split (worker: read, encode, copy; consumer: decode) gives
    the feed's own stream, and sizes the codec's staging sets to depth + 1."""
    ttopo = tenv.create_distribution(8, 1).topology
    batches = _batches(3, 16, (8,), seed=13)
    want = _stream(DeviceFeed(batches, ttopo, wire="int8", quant_block=128, epochs=2))
    feed = DeviceFeed(batches, ttopo, wire="int8", quant_block=128, epochs=2)
    loader = AsyncLoader(feed, depth=3)
    got = _stream(loader)
    loader.close()
    assert feed.codec.slots == 4
    for a, b in zip(got, want):
        for la, lb in zip(a, b):
            _same_bits(la, lb)


def test_feed_refuses_cuda_without_a_card(tenv):
    """No fallback: a feed asked for the card where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    ttopo = tenv.create_distribution(8, 1).topology
    with pytest.raises(MLSLError, match="CUDA is not available"):
        FeedCodec(ttopo, "uint8", device="cuda")


def test_data_common_imports_no_kernel_stack():
    """The lazy exports: importing the package and data.common loads neither
    the codec nor the kernel wrappers."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, mlsl_tpu_torch.data, mlsl_tpu_torch.data.common as c; "
            "c.parse_wire_spec('uint8'); "
            "print(sorted(m for m in sys.modules if m.startswith('mlsl_tpu_torch.data')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert "mlsl_tpu_torch.data.wire" not in proc.stdout
    assert "mlsl_tpu_torch.data.common" in proc.stdout


# -- statistics --------------------------------------------------------------------


def test_feed_line_in_stats_log(tenv, tmp_path, monkeypatch):
    monkeypatch.setenv("MLSL_STATS_DIR", str(tmp_path))
    ttopo = tenv.create_distribution(8, 1).topology
    sess = tenv.create_session()
    list(DeviceFeed(_batches(2, 16, (8,), seed=15), ttopo, wire="uint8", cache_mb=64,
                    epochs=2))
    text = sess.get_stats().print_()
    assert "FEED" in text and "cache 2h/2m" in text
    with open(tmp_path / "mlsl_stats.log") as f:
        assert "FEED" in f.read()


def test_feed_line_surfaces_on_stall_alone(tenv, tmp_path, monkeypatch):
    monkeypatch.setenv("MLSL_STATS_DIR", str(tmp_path))
    sess = tenv.create_session()

    def slow():
        for i in range(2):
            time.sleep(0.03)
            yield np.full((4,), i, np.float32)

    loader = AsyncLoader(slow(), place=lambda b: b, depth=1)
    list(loader)
    loader.close()
    assert tstats.FEED_COUNTERS["batches_staged"] == 0
    assert tstats.FEED_COUNTERS["stall_ms"] > 0
    assert "FEED" in sess.get_stats().print_()
    tstats.reset_feed_counters()
    assert "FEED" not in sess.get_stats().print_()


def test_many_loaders_under_a_short_switch_interval(tenv):
    """Twelve loaders over DeviceFeeds (more worker threads than cores) with
    the interpreter switching threads every microsecond: each stream comes
    out whole and in order, and the process-wide counters lose no update."""
    import sys
    import threading

    ttopo = tenv.create_distribution(8, 1).topology
    n_loaders, n_batches = 12, 15
    sources = [[(np.full((16, 4), 100 * k + i, np.float32), np.full((16,), i, np.int32))
                for i in range(n_batches)] for k in range(n_loaders)]
    results = [None] * n_loaders

    def consume(k):
        loader = AsyncLoader(DeviceFeed(sources[k], ttopo, wire="uint8"), depth=2)
        results[k] = [int(_host(b[1])[0]) for b in loader]
        loader.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(k,)) for k in range(n_loaders)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert results == [list(range(n_batches))] * n_loaders
    assert tstats.FEED_COUNTERS["batches_staged"] == n_loaders * n_batches
    assert tstats.FEED_COUNTERS["wire_bytes"] == n_loaders * n_batches * (16 * 4 + 8 * 8 + 16 * 4)


# -- the fault plane (tests/test_feed.py: the data.prefetch site and the spans) --------


@pytest.fixture(autouse=True)
def fault_plane():
    """Before and after every test of this file: the port's fault plane as
    a fresh process has it, and the JAX chaos registry clear. Its breakers
    are process-wide (a breaker one test trips would degrade the next
    test's rounds), and an Environment another file left live must not
    hand its Config to this file's tests."""
    from mlsl_tpu import chaos as jchaos
    from mlsl_tpu_torch import supervisor

    jchaos.clear()
    supervisor.reset_all()
    yield
    supervisor.reset_all()
    jchaos.clear()


def test_chaos_error_and_delay_through_feed(env, tenv, fault_plane):
    """The same plans on both feeds: a PERSISTENT error surfaces; a
    TRANSIENT one is retried away (its retries counted alike); a delay slows
    and never corrupts -- the batches bit for bit the JAX feed's."""
    from mlsl_tpu import chaos as jchaos
    from mlsl_tpu_torch import chaos

    jt, tt = _topos(env, tenv)
    batches = _batches(2, 16, (8,), seed=10)
    for mod, feed_cls, topo in ((chaos, DeviceFeed, tt), (jchaos, JFeed, jt)):
        mod.plan("data.prefetch", "error")
        with pytest.raises(mod.ChaosError):
            list(feed_cls(batches, topo, wire="uint8", cache_mb=64))
        mod.clear()
        p = mod.plan("data.prefetch", "error", exc=OSError)
        assert len(list(feed_cls(batches, topo, wire="uint8", cache_mb=64, retries=2))) == 2
        assert p.fires == 1
        mod.clear()
    assert tstats.FEED_COUNTERS["retries"] == jstats.FEED_COUNTERS["retries"] >= 1
    outs = []
    for mod, feed_cls, topo in ((chaos, DeviceFeed, tt), (jchaos, JFeed, jt)):
        mod.plan("data.prefetch", "delay", seconds=0.01, times=None)
        outs.append([_host(jax.tree.leaves(b)[0] if mod is jchaos else b[0])
                     for b in feed_cls(batches, topo, wire="uint8", cache_mb=64, epochs=2)])
        mod.clear()
    assert len(outs[0]) == 4
    _same_bits(outs[0][0], outs[0][2])
    for a, b in zip(*outs):
        _same_bits(a, b)


def test_loader_does_not_double_fire_chaos_over_devicefeed(tenv, fault_plane):
    """An AsyncLoader over a DeviceFeed leaves the site to the feed: one hit
    a batch, not two; over a plain source it passes the site itself."""
    from mlsl_tpu_torch import chaos

    tt = tenv.create_distribution(8, 1).topology
    p = chaos.plan("data.prefetch", "delay", seconds=0.0, times=None)
    loader = AsyncLoader(DeviceFeed(_batches(3, 16, (8,), seed=13), tt, wire="none",
                                    cache_mb=0), depth=2)
    assert len(list(loader)) == 3
    loader.close()
    assert p.hits == 3
    it = iter(_batches(2, seed=1))
    loader = AsyncLoader(lambda: next(it), place=lambda x, y: (x, y), depth=1, retries=0)
    with pytest.raises(StopIteration):
        for _ in range(5):
            next(loader)
    loader.close()
    assert p.hits == 3 + 3      # two reads and the one that ended the stream


def test_feed_bitrot_plans_stay_armed(tenv, fault_plane):
    """The bitrot kind waits for ROADMAP A.7b: the feed's reads neither fire
    nor spend a bitrot plan."""
    from mlsl_tpu_torch import chaos

    tt = tenv.create_distribution(8, 1).topology
    p = chaos.plan("data.prefetch", "bitrot")
    assert len(list(DeviceFeed(_batches(2, seed=3), tt, wire="uint8", cache_mb=0))) == 2
    assert (p.hits, p.fires) == (0, 0) and chaos.active()


def test_feed_spans_on_timeline(env, tenv, fault_plane):
    from mlsl_tpu import obs as jobs
    from mlsl_tpu_torch import obs

    jt, tt = _topos(env, tenv)
    names = []
    for mod, feed_cls, topo in ((obs, DeviceFeed, tt), (jobs, JFeed, jt)):
        tr = mod.enable()
        tr.clear()
        list(feed_cls(_batches(2, 16, (8,), seed=14), topo, wire="uint8", cache_mb=64,
                      epochs=2))
        names.append(sorted((e[2], e[1]) for e in tr.snapshot()))
        assert len(tr.span_durations("h2d.transfer", "feed")) == 2
        mod.disable()
    assert names[0] == names[1]
    assert {("feed", "h2d.transfer"), ("feed", "feed.decode"),
            ("feed", "feed.cache_hit")} <= set(names[0])
