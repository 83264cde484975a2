"""The port reads the JAX package's ``SEPTPU01`` checkpoints without JAX,
flax or msgpack (speech_separation_tpu_torch/utils/msgpack_lite.py,
train/checkpoint.read_septpu01), and converts checkpoints across the
reference, the JAX package and the port (utils/import_reference.py; the
``info``, ``import-model`` and ``export-model`` subcommands).

Checked on the CPU, for all six archs at small widths, with checkpoints the
JAX package's own ``save_checkpoint`` writes (params, state, the train
loop's optax state and the generator key):
- the decoder against ``flax.serialization.msgpack_restore``: the same tree,
  every leaf of the same dtype, shape and bytes; also with arrays split by
  flax's chunking (``MAX_CHUNK_SIZE`` monkeypatched here, in flax only), on
  a payload of every msgpack length class, and a bfloat16 leaf widened to
  float32 exactly; an unknown ext type raises with its code;
- ``load_model`` on each file: the port's pipeline on the ``SEPTPU01`` file
  against the JAX pipeline on the same file, waveforms atol 2e-4 (the
  pipeline parity tests' bound, tests/test_torch_pipeline.py); eval-masks
  on a uPIT file equal to eval-masks on its exported ``.mdl`` (atol 0);
- ``info``: the same stdout as the JAX CLI's;
- ``import-model`` / ``export-model``: key for key, the same values as the
  JAX package's import_reference_model / export_reference_model; the
  other four archs' export raises.
"""

import contextlib
import io
import os

import jax
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from speech_separation_tpu.cli.main import main as jax_main
from speech_separation_tpu.eval.pipeline import SeparationPipeline as JaxPipeline
from speech_separation_tpu.models.registry import get_arch as jax_arch
from speech_separation_tpu.train.checkpoint import save_checkpoint as jax_save
from speech_separation_tpu.train.loop import TrainLoopConfig, make_optimizer
from speech_separation_tpu.utils.import_torch import (export_reference_model as jax_export,
                                                      import_reference_model as jax_import)
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
from speech_separation_tpu_torch.train.checkpoint import read_septpu01
from speech_separation_tpu_torch.utils import msgpack_lite
from speech_separation_tpu_torch.utils.weights import state_dict_from_jax

from torch_session import built_once

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

SMALL = {
    "uPIT": {"feat_dim": "257", "hidden": "16", "num_layers": "2"},
    "RSH": {"feat_dim": "257", "hidden": "12", "num_layers": "1"},
    "TCN": {"feat_dim": "257", "channels": "16", "hidden": "24", "blocks": "3", "repeats": "2"},
    "SepFormer": {"n_filters": "16", "filter_len": "16", "stride": "8", "channels": "16",
                  "heads": "2", "d_ff": "24", "chunk": "8", "blocks": "2"},
    "DPRNN": {"n_filters": "16", "filter_len": "16", "stride": "8", "channels": "12",
              "rnn_hidden": "10", "chunk": "8", "blocks": "2"},
    "ConvTasNet": {"n_filters": "32", "filter_len": "16", "stride": "8", "channels": "16",
                   "hidden": "24", "kernel": "3", "blocks": "3", "repeats": "2"},
}
ZERO_STATE = {"zero_init_hidden": "1"}        # the N(0, 1) initial state draws differ
WAVE_ATOL = 2e-4


def quiet(*_):
    pass


def write_jax_checkpoint(path, arch, seed=0):
    cfg = jax_arch(arch).Config.from_kwargs(**SMALL[arch])
    params, state = jax_arch(arch).init(jax.random.PRNGKey(seed), cfg)
    opt_state = make_optimizer(TrainLoopConfig(arch=arch)).init(params)
    jax_save(path, params=params, state=state, opt_state=opt_state,
             rng=jax.random.key_data(jax.random.PRNGKey(seed + 1)), epoch=7,
             meta={"arch": arch, "model_kwargs": SMALL[arch]})


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One JAX checkpoint of each arch, written once per session."""
    def build(root):
        for k, arch in enumerate(SMALL):
            write_jax_checkpoint(str(root / f"{arch}.ckpt"), arch, seed=k)
    root = built_once(tmp_path_factory, "septpu01", build)
    return {arch: str(root / f"{arch}.ckpt") for arch in SMALL}


def flax_payload(path):
    with open(path, "rb") as f:
        f.read(8)
        hlen = int.from_bytes(f.read(4), "little")
        f.read(hlen)
        return serialization.msgpack_restore(f.read())


def assert_same_tree(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, list(got), list(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), (where, type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), where
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@pytest.mark.parametrize("arch", list(SMALL))
def test_decoder_matches_flax_leaf_for_leaf(ckpts, arch):
    got = read_septpu01(ckpts[arch])
    want = flax_payload(ckpts[arch])
    assert set(want) == {"params", "state", "opt_state", "rng"}
    for key in want:
        assert_same_tree(got[key], want[key], key)
    assert got["epoch"] == 7 and got["meta"] == {"arch": arch, "model_kwargs": SMALL[arch]}


def test_chunked_arrays_are_reassembled(tmp_path, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 200)
    path = str(tmp_path / "chunked.ckpt")
    write_jax_checkpoint(path, "uPIT")
    with open(path, "rb") as f:
        raw = f.read()
    assert b"__msgpack_chunked_array__" in raw
    got = read_septpu01(path)
    for key, want in flax_payload(path).items():
        assert_same_tree(got[key], want, key)


def test_every_length_class_scalar_and_bfloat16():
    import ml_dtypes
    tree = {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63, -1, -32, -33, -128,
                 -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63],
        "floats": [0.5, -1e300, float("inf")], "flags": [None, True, False],
        "s": ["", "x" * 31, "y" * 32, "z" * 300, "w" * 70000], "b": [b"", b"q" * 300,
                                                                    b"r" * 70000],
        "long_list": list(range(20)), "long_map": {str(i): i for i in range(20)},
        "arr": np.arange(12, dtype=np.int64).reshape(3, 4),
        "f16": np.linspace(-1, 1, 5, dtype=np.float16), "scalar": np.float32(2.5),
        "empty": np.zeros((0, 3), np.float32), "bf16": np.array([1.5, -2.25, 3.0e30],
                                                                 ml_dtypes.bfloat16),
    }
    blob = serialization.msgpack_serialize(tree)
    got = msgpack_lite.unchunk(msgpack_lite.unpackb(blob))
    want = serialization.msgpack_restore(blob)
    bf16 = want.pop("bf16")
    assert_same_tree({k: v for k, v in got.items() if k != "bf16"}, want)
    assert got["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["bf16"], bf16.astype(np.float32))
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack_lite.unpackb(msgpack.packb(msgpack.ExtType(2, b"\x00")))
    with pytest.raises(ValueError, match="truncated"):
        msgpack_lite.unpackb(blob[:-3])


@pytest.mark.parametrize("arch", list(SMALL))
def test_load_model_runs_the_jax_forward(ckpts, arch):
    kw = ZERO_STATE if arch in ("uPIT", "RSH") else {}
    rng = np.random.default_rng(3)
    sigs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 1700)]
    ref = JaxPipeline(ckpts[arch], model_kwargs=kw, batch_size=4,
                      length_quantum=4096).separate(sigs)
    pipe = SeparationPipeline(ckpts[arch], model_kwargs=kw, batch_size=4,
                              length_quantum=4096, device="cpu")
    assert pipe.arch.NAME == arch
    got = pipe.separate(sigs)
    for r, g, s in zip(ref, got, sigs):
        assert len(r) == len(g)
        for a, c in zip(r, g):
            assert a.shape == c.shape and len(a) <= len(s)
            np.testing.assert_allclose(c, a, atol=WAVE_ATOL)


def test_eval_masks_and_separate_take_a_jax_checkpoint(ckpts, tmp_path):
    from speech_separation_tpu_torch.dsp.extract import extract_features
    from speech_separation_tpu_torch.utils.audio import load_wav, write_wav_int16
    from speech_separation_tpu_torch.utils.synthetic import make_synthetic_corpus
    corpus = str(tmp_path / "corpus")
    ids = make_synthetic_corpus(corpus, 2, seed=2, prefix="ev")
    data = tmp_path / "data"
    data.mkdir()
    (data / "wav.scp").write_text("".join(f"{u} {corpus}/mix/{u}.wav\n" for u in ids))
    extract_features(str(data), "test", str(tmp_path / "feats"), device="cpu")
    mdl = str(tmp_path / "upit.mdl")
    main(["export-model", ckpts["uPIT"], mdl])
    for model, out in ((ckpts["uPIT"], "m_ckpt"), (mdl, "m_mdl")):
        main(["eval-masks", model, str(data), str(tmp_path / out), "--model-config",
              _conf(tmp_path, ZERO_STATE), "--device", "cpu"])
    for u in ids:
        with np.load(tmp_path / "m_ckpt" / f"{u}.npz") as a, \
                np.load(tmp_path / "m_mdl" / f"{u}.npz") as b:
            assert sorted(a.files) == sorted(b.files) == ["s1", "s2"]
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    wav = str(tmp_path / "mix.wav")
    write_wav_int16(wav, 8000, load_wav(f"{corpus}/mix/{ids[0]}.wav")[0])
    main(["separate", ckpts["ConvTasNet"], str(tmp_path / "sep"), wav, "--device", "cpu"])
    assert all(os.path.isfile(tmp_path / "sep" / f"mix_s{s}.wav") for s in (1, 2))


def _conf(tmp_path, kw):
    path = tmp_path / "model.conf"
    path.write_text("".join(f"{k}={v}\n" for k, v in kw.items()))
    return str(path)


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.mark.parametrize("arch", list(SMALL))
def test_info_prints_what_the_jax_cli_prints(ckpts, arch):
    want = _stdout(jax_main, ["info", ckpts[arch]])
    assert _stdout(main, ["info", ckpts[arch]]) == want
    assert "optimizer state: present" in want and "rng state: present" in want


def _torch_sd(path):
    return {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}


def _same_sd(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ["uPIT", "RSH"])
def test_import_and_export_agree_with_the_jax_package(ckpts, arch, tmp_path):
    # export: a SEPTPU01 file to the reference .mdl, both packages
    jax_export(ckpts[arch], str(tmp_path / "jax.mdl"), log=quiet)
    main(["export-model", ckpts[arch], str(tmp_path / "port.mdl")])
    want = _torch_sd(tmp_path / "jax.mdl")
    _same_sd(_torch_sd(tmp_path / "port.mdl"), want)

    # a reference .mdl with both LSTM biases set, as torch trains them
    ref = {k: v.copy() for k, v in want.items()}
    for k in ref:
        if "bias_hh" in k:
            ref[k] = np.random.default_rng(0).standard_normal(ref[k].shape).astype(np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in ref.items()}, tmp_path / "ref.mdl")
    jax_import(str(tmp_path / "ref.mdl"), str(tmp_path / "imported.ckpt"), log=quiet)
    main(["import-model", str(tmp_path / "ref.mdl"), str(tmp_path / "imported.mdl")])
    jax_ckpt = read_septpu01(str(tmp_path / "imported.ckpt"))
    _same_sd(_torch_sd(tmp_path / "imported.mdl"),
             {k: v.numpy() for k, v in state_dict_from_jax(jax_ckpt["params"],
                                                            jax_ckpt["state"]).items()})
    meta = torch.load(tmp_path / "imported.state", weights_only=True)["meta"]
    assert meta == {**jax_ckpt["meta"], "imported_from": str(tmp_path / "ref.mdl")}

    # the port's own checkpoint exports as the JAX package's SEPTPU01 does
    jax_export(str(tmp_path / "imported.ckpt"), str(tmp_path / "jax2.mdl"), log=quiet)
    main(["export-model", str(tmp_path / "imported.mdl"), str(tmp_path / "port2.mdl")])
    _same_sd(_torch_sd(tmp_path / "port2.mdl"), _torch_sd(tmp_path / "jax2.mdl"))
    # and a SEPTPU01 file imports with the header's meta
    main(["import-model", ckpts[arch], str(tmp_path / "from_ckpt.mdl")])
    meta = torch.load(tmp_path / "from_ckpt.state", weights_only=True)["meta"]
    assert meta == {"arch": arch, "model_kwargs": SMALL[arch], "imported_from": ckpts[arch]}
    assert _stdout(main, ["info", str(tmp_path / "from_ckpt.mdl")]).startswith(f"arch: {arch}\n")


@pytest.mark.parametrize("arch", ["TCN", "SepFormer", "DPRNN", "ConvTasNet"])
def test_export_of_other_archs_raises(ckpts, arch, tmp_path):
    with pytest.raises(ValueError, match="only the reference archs"):
        main(["export-model", ckpts[arch], str(tmp_path / "x.mdl")])
    assert not (tmp_path / "x.mdl").exists()
