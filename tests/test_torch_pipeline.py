"""The port's SeparationPipeline and SeparationServer
(speech_separation_tpu_torch/eval) against the JAX package's pipeline on the
CPU: a small JAX uPIT saved with save_checkpoint, exported to a reference
.mdl with utils/import_torch.state_dict_from_params, the same signals
separated by both.

Tolerance: waveforms atol 2e-4 (the JAX pipeline's own test against its
staged path; f32 throughout, other summation orders).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from speech_separation_tpu.eval.pipeline import SeparationPipeline as JaxPipeline
from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu.train.checkpoint import save_checkpoint
from speech_separation_tpu.utils.import_torch import state_dict_from_params
from speech_separation_tpu_torch.eval.infer import load_model
from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
from speech_separation_tpu_torch.eval.serve import SeparationServer, request
from speech_separation_tpu_torch.utils.audio import load_wav, write_wav_int16

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

KW = {"hidden": "16", "num_layers": "1", "zero_init_hidden": "1"}
WAVE_ATOL = 2e-4


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipe")
    cfg = jupit.Config(feat_dim=257, num_spk=2, hidden=16, num_layers=1,
                       zero_init_hidden=True)
    params, state = jupit.init(jax.random.PRNGKey(0), cfg)
    ckpt = str(root / "model.ckpt")
    save_checkpoint(ckpt, params=params, state=state, epoch=0, meta={"arch": "uPIT"})
    mdl = str(root / "model.mdl")
    sd = state_dict_from_params(jax.device_get(params), jax.device_get(state))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, mdl)
    return root, ckpt, mdl


def _signals(lengths, seed):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


def test_separate_matches_jax_pipeline(models):
    _, ckpt, mdl = models
    sigs = _signals((7000, 5000, 3210), seed=0)
    ref = JaxPipeline(ckpt, model_kwargs=KW, batch_size=4,
                      length_quantum=4096).separate(sigs)
    pipe = SeparationPipeline(mdl, model_kwargs=KW, batch_size=4,
                              length_quantum=4096, device="cpu")
    got = pipe.separate(sigs)
    for r, g in zip(ref, got):
        assert len(g) == 2
        for a, b in zip(r, g):
            assert a.shape == b.shape
            np.testing.assert_allclose(b, a, atol=WAVE_ATOL)
    assert pipe.buckets == {(4096 // 128 * 2 + 1, 2)}


def test_padded_batches_and_long_form_match_jax(models):
    """pad_batches (pad rows of 1 frame) and the windowed long-form path."""
    _, ckpt, mdl = models
    jp = JaxPipeline(ckpt, model_kwargs=KW, batch_size=4, length_quantum=4096)
    tp = SeparationPipeline(mdl, model_kwargs=KW, batch_size=4,
                            length_quantum=4096, device="cpu")
    sigs = _signals((4000, 2500), seed=1)
    ref = dict(jp.separate_stream(sigs.__getitem__, [4000, 2500], pad_batches=True))
    got = dict(tp.separate_stream(sigs.__getitem__, [4000, 2500], pad_batches=True))
    for i in ref:
        for a, b in zip(ref[i], got[i]):
            np.testing.assert_allclose(b, a, atol=WAVE_ATOL)
    x = _signals((int(2.6 * 8000),), seed=2)[0]
    ref_long = jp.separate_long(x, window_sec=1.0, overlap_sec=0.25)
    got_long = tp.separate_long(x, window_sec=1.0, overlap_sec=0.25)
    for a, b in zip(ref_long, got_long):
        assert len(b) == len(x)
        np.testing.assert_allclose(b, a, atol=WAVE_ATOL)


def test_cli_separate_writes_the_pipeline_tracks(models, tmp_path):
    from speech_separation_tpu_torch.cli.main import main
    _, _, mdl = models
    conf = tmp_path / "model.conf"
    conf.write_text("".join(f"{k}={v}\n" for k, v in KW.items()))
    wav = str(tmp_path / "mix.wav")
    write_wav_int16(wav, 8000, _signals((5000,), seed=4)[0])
    out = str(tmp_path / "out")
    main(["separate", mdl, out, wav, "--model-config", str(conf), "--device", "cpu"])
    pipe = SeparationPipeline(mdl, model_kwargs=KW, device="cpu")
    ref = pipe.separate([load_wav(wav)[0]])[0]
    for s, track in enumerate(ref):
        y, _ = load_wav(os.path.join(out, f"mix_s{s + 1}.wav"))
        np.testing.assert_allclose(y, track, atol=2.0 / 32767)


def test_jax_checkpoint_is_refused_with_a_pointer(models, tmp_path):
    """The JAX package's checkpoint loads natively (train/checkpoint.
    read_septpu01) into the model its exported .mdl gives; a SEPTPU01 file
    whose payload holds what flax never writes is refused with a pointer to
    the file and the msgpack ext type."""
    _, ckpt, mdl = models
    _, _, from_ckpt = load_model(ckpt, model_kwargs=KW, device="cpu")
    _, _, from_mdl = load_model(mdl, model_kwargs=KW, device="cpu")
    want = from_mdl.state_dict()
    for k, v in from_ckpt.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    bad = tmp_path / "bad.ckpt"
    with open(ckpt, "rb") as f:
        head = f.read(12)
        head += f.read(int.from_bytes(head[8:12], "little"))
    bad.write_bytes(head + b"\xd4\x05\x00")          # fixext1 of ext type 5
    with pytest.raises(ValueError, match="bad.ckpt.*ext type 5"):
        load_model(str(bad), device="cpu")


def test_server_answers_requests_and_ping(models, tmp_path):
    root, _, mdl = models
    wavs = []
    for k, n in enumerate((6000, 3500, 4100)):
        path = str(tmp_path / f"in{k}.wav")
        write_wav_int16(path, 8000, _signals((n,), seed=10 + k)[0])
        wavs.append(path)
    pipe = SeparationPipeline(mdl, model_kwargs=KW, batch_size=4,
                              length_quantum=4096, device="cpu")
    sock = os.path.join(str(tmp_path), "s.sock")
    server = SeparationServer(pipe, sock, coalesce=8)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 30
        while not os.path.exists(sock):
            assert time.monotonic() < deadline, "server never bound its socket"
            time.sleep(0.02)
        replies = [None, None]

        def send(k, payload):
            replies[k] = request(sock, payload, timeout=120)

        out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
        threads = [threading.Thread(target=send, args=(0, {"wavs": wavs[:2], "out_dir": out_a})),
                   threading.Thread(target=send, args=(1, {"wavs": wavs[2:], "out_dir": out_b}))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        assert all(r["ok"] for r in replies), replies
        direct = pipe.separate([load_wav(w)[0] for w in wavs])
        for wav, tracks in zip(wavs, direct):
            rep = replies[0] if wav in replies[0]["outputs"] else replies[1]
            paths = rep["outputs"][wav]
            assert [os.path.basename(p) for p in paths] == [
                os.path.basename(wav)[:-4] + f"_s{s}.wav" for s in (1, 2)]
            for p, ref in zip(paths, tracks):
                y, sr = load_wav(p)
                assert sr == 8000 and len(y) == len(ref)
                np.testing.assert_allclose(y, ref, atol=2.0 / 32767)
        ping = request(sock, {"cmd": "ping"})
        assert ping["ok"] and ping["served"] == 2 and ping["compiled_buckets"] >= 1
        assert not request(sock, {"cmd": "stream_open"})["ok"]
        assert not request(sock, {"wavs": [], "out_dir": out_a})["ok"]
    finally:
        server.shutdown()
        t.join(timeout=10)
    assert not t.is_alive()
