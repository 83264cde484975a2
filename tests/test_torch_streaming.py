"""The port's live separation (speech_separation_tpu_torch/eval/streaming.py
and the ``stream_*`` protocol of eval/serve.py) on the CPU, with a causal
TCN (spectral) and a causal Conv-TasNet (time domain) at tiny widths: each
stream against the JAX package's StreamingSeparator on the same weights and
against the port's offline pipeline, and the JAX package's properties held
on the port (push granularity invisible, emitted samples never revised, the
structural latency, pool slots equal to solo streams, slot reuse, the error
paths), then a live stream through the port's SeparationServer on a Unix
socket, and the ``serve`` flags.

Tolerances: a stream against the offline pipeline atol 2e-5, the JAX
package's own limit (tests/test_streaming.py, tests/test_streaming_time.py:
the chunk's products against the pipeline's batched ones, sums in another
order), and against the JAX package's stream atol 2e-5 (the same f32 math).
Push granularity atol 1e-6 and pooled slots against solo streams atol 2e-6
(TCN) and 1e-6 (Conv-TasNet), the JAX package's limits (a batch of 4 rows
against 1 sums in another order). Emitted samples are never revised:
exactly. Served streams: the pcm16 codec quantizes to 1/32768, so a served
track is held to the same stream's float samples at 1/32768 + 2e-5.
"""

import base64
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from speech_separation_tpu.eval.streaming import StreamingSeparator as JaxStreamingSeparator
from speech_separation_tpu.models import convtasnet as jct
from speech_separation_tpu.models import tcn as jtcn
from speech_separation_tpu.train.checkpoint import save_checkpoint as jax_save
from speech_separation_tpu_torch.cli.main import build_parser
from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
from speech_separation_tpu_torch.eval.serve import SeparationServer, request
from speech_separation_tpu_torch.eval.streaming import StreamingPool, StreamingSeparator
from speech_separation_tpu_torch.models import convtasnet as tct
from speech_separation_tpu_torch.models import tcn as ttcn
from speech_separation_tpu_torch.models import upit as tupit
from speech_separation_tpu_torch.train.checkpoint import save_checkpoint
from speech_separation_tpu_torch.utils.weights import pytree_state_dict_from_jax

from torch_session import built_once

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

S = 2
TCN_KW = {"channels": "16", "hidden": "24", "blocks": "3", "repeats": "2", "causal": "1"}
CT_TINY = dict(n_filters=32, filter_len=16, stride=8, channels=16, hidden=24, kernel=3,
               blocks=3, repeats=2)
CT_KW = {k: str(v) for k, v in dict(CT_TINY, causal=1).items()}
# per domain: model kwargs, the chunk program's frame hop, pool-against-solo atol
DOMAINS = {"TCN": (TCN_KW, 128, 2e-6), "ConvTasNet": (CT_KW, CT_TINY["stride"], 1e-6)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{arch: (the port's .mdl, the JAX checkpoint)} with the same weights,
    written once per session."""
    archs = (("TCN", jtcn, ttcn, jtcn.Config.from_kwargs(**TCN_KW)),
             ("ConvTasNet", jct, tct, jct.Config.from_kwargs(**CT_KW)))

    def build(root):
        for name, jmod, tmod, jcfg in archs:
            kw = DOMAINS[name][0]
            params, state = jmod.init(jax.random.PRNGKey(0), jcfg)
            jax_save(str(root / f"{name}.ckpt"), params=params, state=state,
                     meta={"arch": name, "model_kwargs": kw})
            model = tmod.Model(tmod.Config.from_kwargs(**kw))
            model.load_state_dict(pytree_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, params)))
            save_checkpoint(str(root / f"{name}.mdl"), model,
                            meta={"arch": name, "model_kwargs": kw})

    root = built_once(tmp_path_factory, "stream", build)
    return {name: (str(root / f"{name}.mdl"), str(root / f"{name}.ckpt"))
            for name, *_ in archs}


def _audio(n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _run(sep, x, blocks):
    outs = [[] for _ in range(S)]
    i = 0
    for blk in blocks:
        for s, t in enumerate(sep.push(x[i: i + blk])):
            outs[s].append(t)
        i += blk
    assert i == len(x)
    for s, t in enumerate(sep.close()):
        outs[s].append(t)
    return [np.concatenate(o) for o in outs]


def _stream(mdl, x, blocks, chunk_frames=8):
    return _run(StreamingSeparator(mdl, chunk_frames=chunk_frames, device="cpu"), x, blocks)


BLOCKS = (100, 57, 1000, 3, 2048, 900, 1800, 79)


@pytest.mark.parametrize("arch", list(DOMAINS))
def test_stream_equals_offline_and_the_jax_stream(models, arch):
    """The concatenated emissions equal the port's offline pipeline on the
    same audio, at its length, and the JAX package's stream, with a ragged
    tail (a partial final chunk)."""
    mdl, ckpt = models[arch]
    x = _audio(5987, 5)
    off = SeparationPipeline(mdl, batch_size=1, length_quantum=1024,
                             device="cpu").separate([x])[0]
    got = _stream(mdl, x, BLOCKS)
    ref = _run(JaxStreamingSeparator(ckpt, chunk_frames=8, model_kwargs=DOMAINS[arch][0]),
               x, BLOCKS)
    for s in range(S):
        assert len(got[s]) == len(off[s]) == len(ref[s])
        if arch == "ConvTasNet":
            assert len(got[s]) == len(x)
        np.testing.assert_allclose(got[s], off[s], atol=2e-5)
        np.testing.assert_allclose(got[s], ref[s], atol=2e-5)


@pytest.mark.parametrize("arch", list(DOMAINS))
def test_push_granularity_invisible(models, arch):
    mdl = models[arch][0]
    x = _audio(3000, 7)
    a = _stream(mdl, x, (3000,))
    b = _stream(mdl, x, (1,) * 100 + (700, 2200))
    for s in range(S):
        np.testing.assert_allclose(a[s], b[s], atol=1e-6)


@pytest.mark.parametrize("arch", list(DOMAINS))
def test_emitted_samples_never_revised(models, arch):
    """Whatever arrives later, samples already out stay as they were."""
    mdl = models[arch][0]
    x = _audio(8000, 9)
    sep1, sep2 = (StreamingSeparator(mdl, chunk_frames=8, device="cpu") for _ in range(2))
    got1, got2 = sep1.push(x[:4096]), sep2.push(x[:4096])
    n = min(len(got1[0]), len(got2[0]))
    assert n > 0
    sep1.push(x[4096:])
    sep2.push(-x[4096:])
    for s in range(S):
        np.testing.assert_array_equal(got1[s][:n], got2[s][:n])


@pytest.mark.parametrize("arch", list(DOMAINS))
def test_latency_is_structural(models, arch):
    """After N samples in, all but the chunk and the structural lookahead
    (n_fft/2 + one window; one encoder window) are out."""
    mdl, hop = models[arch][0], DOMAINS[arch][1]
    sep = StreamingSeparator(mdl, chunk_frames=8, device="cpu")
    bound = 8 * hop + (256 + 512 if arch == "TCN" else CT_TINY["filter_len"])
    emitted = 0
    for i in range(0, 6000, 500):
        emitted += len(sep.push(_audio(500, i)[: min(500, 6000 - i)])[0])
        assert emitted >= min(i + 500, 6000) - bound - 500, (i, emitted)


def test_stream_errors_and_refused_models(models, tmp_path):
    mdl = models["TCN"][0]
    sep = StreamingSeparator(mdl, device="cpu")
    sep.push(_audio(1000, 1))
    sep.close()
    with pytest.raises(RuntimeError):
        sep.push(np.zeros(10, np.float32))
    with pytest.raises(RuntimeError):
        sep.close()
    short = StreamingSeparator(mdl, device="cpu")
    short.push(np.zeros(10, np.float32))
    with pytest.raises(ValueError, match="too short"):
        short.close()
    empty = StreamingSeparator(models["ConvTasNet"][0], device="cpu")
    with pytest.raises(ValueError, match="too short"):
        empty.close()

    # a non-causal model, and another arch, with the JAX package's message
    nc = str(tmp_path / "nc.mdl")
    kw = {k: v for k, v in TCN_KW.items() if k != "causal"}
    save_checkpoint(nc, ttcn.TCN(ttcn.Config.from_kwargs(**kw)), meta={"arch": "TCN",
                                                                      "model_kwargs": kw})
    with pytest.raises(ValueError, match="streaming needs a causal model .* causal=False"):
        StreamingSeparator(nc, device="cpu")
    up = str(tmp_path / "upit.mdl")
    ukw = {"hidden": "8", "num_layers": "1"}
    save_checkpoint(up, tupit.UPIT(tupit.Config.from_kwargs(**ukw)),
                    meta={"arch": "uPIT", "model_kwargs": ukw})
    with pytest.raises(ValueError, match="arch=uPIT"):
        StreamingPool(up, device="cpu")


def test_streaming_defaults_to_cuda(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSeparator(models["TCN"][0])
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingPool(models["ConvTasNet"][0])


@pytest.mark.parametrize("arch", list(DOMAINS))
def test_pool_streams_match_solo(models, arch):
    """Two pool streams with interleaved pushes; b arrives in two bursts, so
    it starves (frozen state) while a advances."""
    mdl, tol = models[arch][0], DOMAINS[arch][2]
    xa, xb = _audio(7000, 21), _audio(9000, 22)
    solo = {"a": _stream(mdl, xa, (len(xa),)), "b": _stream(mdl, xb, (len(xb),))}
    pool = StreamingPool(mdl, capacity=4, chunk_frames=8, device="cpu")
    a, b = pool.open(), pool.open()
    got = {a: [[], []], b: [[], []]}

    def take(results):
        for slot, tracks in results.items():
            for s in range(S):
                got[slot][s].append(tracks[s])

    for i in range(0, 7000, 500):
        pool.push(a, xa[i: i + 500])
        if i == 0:
            pool.push(b, xb[:1500])
        if i == 4000:
            pool.push(b, xb[1500:])
        take(pool.step())
    take({b: pool.close(b)})
    take({a: pool.close(a)})
    for slot, key in ((a, "a"), (b, "b")):
        for s in range(S):
            mine = np.concatenate(got[slot][s])
            assert len(mine) == len(solo[key][s])
            np.testing.assert_allclose(mine, solo[key][s], atol=tol)


@pytest.mark.parametrize("arch", list(DOMAINS))
def test_pool_slot_reuse_and_errors(models, arch):
    mdl, tol = models[arch][0], DOMAINS[arch][2]
    pool = StreamingPool(mdl, capacity=2, chunk_frames=8, device="cpu")
    a, _ = pool.open(), pool.open()
    with pytest.raises(RuntimeError, match="pool full"):
        pool.open()
    pool.push(a, _audio(3000, 1))
    tracks = pool.close(a)
    assert len(tracks) == S and len(tracks[0]) > 0
    with pytest.raises(RuntimeError, match="not open"):
        pool.push(a, np.zeros(10, np.float32))
    with pytest.raises(RuntimeError, match="not open"):
        pool.close(a)
    # the freed slot starts from zeroed state: the same input there equals a
    # fresh solo stream
    c = pool.open()
    assert c == a
    x = _audio(4000, 2)
    pool.push(c, x)
    out_pool = pool.close(c)
    out_solo = _stream(mdl, x, (4000,))
    for s in range(S):
        np.testing.assert_allclose(out_pool[s], out_solo[s], atol=tol)


# ------------------------------------------------------------------ server

def _f32(b64):
    return np.frombuffer(base64.b64decode(b64), dtype="<i2").astype(np.float32) / 32768.0


@pytest.fixture()
def server(models, tmp_path):
    """A port server on a Unix socket, its pipeline the causal TCN and its
    stream pool of capacity 2 the causal Conv-TasNet."""
    mdl = models["ConvTasNet"][0]
    pipe = SeparationPipeline(models["TCN"][0], batch_size=2, device="cpu")
    pool = StreamingPool(mdl, capacity=2, chunk_frames=8, device="cpu")
    sock = str(tmp_path / "s.sock")
    srv = SeparationServer(pipe, sock, stream_pool=pool)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    deadline = time.monotonic() + 30
    while not os.path.exists(sock):
        assert time.monotonic() < deadline, "server never bound its socket"
        time.sleep(0.02)
    yield sock, mdl
    srv.shutdown()
    th.join(timeout=30)
    assert not th.is_alive()


def _pcm16(x):
    return base64.b64encode(np.clip(np.rint(x * 32768.0), -32768, 32767)
                            .astype("<i2").tobytes()).decode()


def test_live_stream_through_the_server(server):
    sock, mdl = server
    x = np.round(_audio(3000, 31) * 32768.0) / 32768.0     # pcm16-exact input
    opened = request(sock, {"cmd": "stream_open"})
    assert opened["ok"] and opened["sample_rate"] == 8000 and opened["num_spk"] == S
    slot = opened["slot"]
    other = request(sock, {"cmd": "stream_open"})["slot"]
    assert other != slot
    got = [[] for _ in range(S)]
    for i in range(0, 3000, 700):
        rep = request(sock, {"cmd": "stream_push", "slot": slot, "pcm16": _pcm16(x[i: i + 700])})
        assert rep["ok"] and len(rep["tracks"]) == S
        for s in range(S):
            got[s].append(_f32(rep["tracks"][s]))
        # the other slot is open and starves: its state stays frozen
        assert request(sock, {"cmd": "stream_push", "slot": other, "pcm16": ""})["ok"]
    rep = request(sock, {"cmd": "stream_close", "slot": slot})
    assert rep["ok"]
    for s in range(S):
        got[s].append(_f32(rep["tracks"][s]))
    ref = _stream(mdl, x.astype(np.float32), (3000,))
    for s in range(S):
        track = np.concatenate(got[s])
        assert len(track) == len(x)
        np.testing.assert_allclose(track, np.clip(ref[s], -1, 32767 / 32768),
                                   atol=1 / 32768 + 2e-5)

    # error paths: a slot not open, bad pcm16, the wrong type
    for payload in ({"cmd": "stream_push", "slot": slot, "pcm16": ""},
                    {"cmd": "stream_close", "slot": 7},
                    {"cmd": "stream_push", "slot": True, "pcm16": ""}):
        rep = request(sock, payload)
        assert not rep["ok"] and "is not open" in rep["error"]
    rep = request(sock, {"cmd": "stream_push", "slot": other, "pcm16": "not base64!"})
    assert not rep["ok"] and rep["error"].startswith("bad pcm16")
    rep = request(sock, {"cmd": "stream_push", "slot": other, "pcm16": 5})
    assert not rep["ok"] and "'pcm16' must be a base64 string" in rep["error"]
    # a stream too short to close frees its slot
    rep = request(sock, {"cmd": "stream_close", "slot": other})
    assert not rep["ok"] and "too short" in rep["error"]
    assert request(sock, {"cmd": "stream_open"})["ok"]


def test_server_without_a_pool_refuses_streams(models, tmp_path):
    pipe = SeparationPipeline(models["TCN"][0], batch_size=2, device="cpu")
    srv = SeparationServer(pipe, str(tmp_path / "s.sock"))
    for cmd in ("stream_open", "stream_push", "stream_close"):
        rep = srv._dispatch({"cmd": cmd, "slot": 0})
        assert rep == {"ok": False, "error": "server started without --streaming-model"}


def test_serve_parses_the_streaming_flags():
    args = build_parser().parse_args(["serve", "m.mdl", "s.sock", "--streaming-model", "c.mdl"])
    assert (args.streaming_model, args.streaming_model_config, args.stream_capacity,
            args.stream_chunk_frames) == ("c.mdl", "", 8, 16)
    args = build_parser().parse_args(["serve", "m.mdl", "s.sock", "--stream-capacity", "4",
                                      "--stream-chunk-frames", "32",
                                      "--streaming-model-config", "c.conf"])
    assert (args.stream_capacity, args.stream_chunk_frames, args.streaming_model) == (4, 32, "")
