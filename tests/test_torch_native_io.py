"""The port's native loader (speech_separation_tpu_torch/csrc/sepio.cpp through
utils/native.py) against numpy and the JAX package's pure-Python path:

- npz members inflated transposed into padded buffers in modes 0 (f32), 1
  (|complex|, or f32 as it is) and 2 (complex planes), C- and
  Fortran-ordered, against ``np.load(...).T``: equal bit for bit, except
  mode 1's complex magnitude, sqrt(re^2 + im^2) in float32 against numpy's
  hypot, within 1e-6 relative (the JAX package's own test's bound);
- wavs (PCM16, PCM32, float32; mono) decoded bit for bit as
  ``scipy.io.wavfile`` plus librosa's normalization (how the JAX
  ``load_wav`` reads without its native library), and ``load_wav`` itself;
  a uint8 wav, which the decoder does not take, through scipy;
- ``collate_native`` against the JAX package's pure-Python collation
  (``make_device_batch`` over ``FeatureDataset.load``) and the port's numpy
  path, bit for bit, with padding rows and a file without sources;
- ``SEPSEP_NATIVE=0`` turning it off, and two processes building the
  library at once into one build dir (each writes a name of its own and
  renames it into place).

The JAX package's utils/native.py is not called here: it builds into
native/ with make, in place, which races between test workers.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speech_separation_tpu.train import data as jdata
from speech_separation_tpu_torch.train import data as tdata
from speech_separation_tpu_torch.utils import native
from speech_separation_tpu_torch.utils.audio import load_wav

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def loaded():
    assert native.available(), native.status()


def test_npz_member_names(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez_compressed(path, mix=np.zeros((3, 4), np.float32), s1=np.ones((3, 4), np.float32))
    assert sorted(native.npz_member_names(path)) == ["mix", "s1"]


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_members_inflate_transposed_into_padded_buffers(tmp_path, mode, order):
    rng = np.random.default_rng(mode)
    f32 = rng.standard_normal((257, 123)).astype(np.float32)         # (F, T)
    cx = _complex(rng, (257, 123))
    if order == "F":                     # a transposed view: stored Fortran-ordered
        f32 = np.asfortranarray(f32)
        cx = np.asfortranarray(cx)
    path = str(tmp_path / "feat.npz")
    np.savez_compressed(path, mix=f32, cx=cx)
    with np.load(path) as z:
        assert z["mix"].flags.f_contiguous == (order == "F")
    out, out2 = np.zeros((200, 257), np.float32), np.zeros((200, 257), np.float32)
    member = "mix" if mode == 0 else "cx"
    assert native.load_npz_2d_transposed(path, member, out, mode=mode,
                                         out2=out2 if mode == 2 else None) == (123, 257)
    if mode == 0:
        np.testing.assert_array_equal(out[:123], f32.T)
    elif mode == 1:
        np.testing.assert_allclose(out[:123], np.abs(cx).T, rtol=1e-6)
        # an f32 member passes through mode 1 as it is
        f = np.zeros((200, 257), np.float32)
        native.load_npz_2d_transposed(path, "mix", f, mode=1)
        np.testing.assert_array_equal(f[:123], f32.T)
    else:
        np.testing.assert_array_equal(out[:123], cx.real.T)
        np.testing.assert_array_equal(out2[:123], cx.imag.T)
    assert not out[123:].any() and not out2[123:].any()


def test_bad_requests_raise(tmp_path):
    path = str(tmp_path / "feat.npz")
    np.savez(path, mix=np.ones((8, 5), np.float32))
    small = np.zeros((4, 8), np.float32)
    with pytest.raises(IOError, match="-7"):                      # buffer too small
        native.load_npz_2d_transposed(path, "mix", small)
    with pytest.raises(IOError, match="-3"):                      # no such member
        native.load_npz_2d_transposed(path, "s1", np.zeros((5, 8), np.float32))
    with pytest.raises(IOError, match="-6"):                      # mode 2 needs complex
        native.load_npz_2d_transposed(path, "mix", np.zeros((5, 8), np.float32), mode=2,
                                      out2=np.zeros((5, 8), np.float32))
    with pytest.raises(ValueError):
        native.load_npz_2d_transposed(path, "mix", np.zeros((5, 8), np.float64))


def _scipy_reference(path):
    """The JAX package's load_wav without its native library."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0, sr
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0, sr
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0, sr
    return data.astype(np.float32), sr


@pytest.mark.parametrize("dtype", ["int16", "int32", "float32", "uint8"])
def test_wavs_decode_as_the_scipy_path(tmp_path, dtype):
    rng = np.random.default_rng(3)
    x = np.clip(rng.standard_normal(5003) * 0.3, -1, 1)
    data = {"int16": (x * 32767).astype(np.int16),
            "int32": (x * 2147483000).astype(np.int32),
            "float32": x.astype(np.float32),
            "uint8": (x * 127 + 128).astype(np.uint8)}[dtype]
    path = str(tmp_path / f"{dtype}.wav")
    wavfile.write(path, 8000, data)
    ref, sr_ref = _scipy_reference(path)
    got = native.read_wav_f32(path) if dtype != "uint8" else None
    if got is not None:
        np.testing.assert_array_equal(got[0], ref)
        assert got[1] == sr_ref == 8000
    else:
        with pytest.raises(IOError):
            native.read_wav_f32(path)
    y, sr = load_wav(path)
    assert sr == 8000 and y.dtype == np.float32
    np.testing.assert_array_equal(y, ref)


def _feature_dir(root, with_counts=True):
    """Five utterances of 2, 2, 1, 2 sources and one file without sources,
    (F, T) f32 magnitudes, compressed as the extractor writes them."""
    rng = np.random.default_rng(7)
    os.makedirs(root)
    lines, frames, spks = [], [], []
    for i, (T, S) in enumerate([(40, 2), (17, 2), (33, 1), (64, 2), (25, 0)]):
        arrays = {"mix": np.abs(rng.standard_normal((33, T))).astype(np.float32)}
        arrays.update({f"s{s + 1}": np.abs(rng.standard_normal((33, T))).astype(np.float32)
                       for s in range(S)})
        path = os.path.join(root, f"u{i}.npz")
        np.savez_compressed(path, **arrays)
        lines.append(f"u{i} {path}\n")
        frames.append(f"u{i} {T}\n")
        spks.append(f"u{i} {max(S, 1)}\n")
    for name, rows in (("feats_train.scp", lines), ("utt2num_frames", frames),
                       ("utt2num_spk", spks)):
        if with_counts or name == "feats_train.scp":
            with open(os.path.join(root, name), "w") as f:
                f.writelines(rows)
    return root


@pytest.mark.parametrize("idxs", [[0, 1, 2, 3, 4], [3, 1], [4], [2, 0, 4]],
                         ids=["all", "two-of-five-rows", "no-sources", "mixed-counts"])
def test_native_collation_equals_the_pure_python_ones(tmp_path, idxs):
    d = _feature_dir(str(tmp_path / "d"))
    ds = tdata.FeatureDataset(d, log=lambda *_: None)
    assert ds.collation == "native"
    plan = tdata.BatchPlan(batch_size=5, time_pad_multiple=16)
    got = tdata.collate(ds, idxs, plan)
    numpy_path = tdata.make_device_batch([ds.load(i) for i in idxs], plan)
    jds = jdata.FeatureDataset(d)
    jax_path = jdata.make_device_batch([jds.load(i) for i in idxs],
                                       jdata.BatchPlan(batch_size=5, time_pad_multiple=16))
    for ref in (numpy_path, jax_path):
        assert got["names"] == ref["names"]
        for k in ("mix", "sources", "lengths", "row_mask"):
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_without_counts_the_dataset_collates_by_numpy(tmp_path, monkeypatch):
    d = _feature_dir(str(tmp_path / "d"), with_counts=False)
    logs, asked = [], []
    # a dataset that cannot collate natively does not build the library
    monkeypatch.setattr(native, "available", lambda: asked.append(1) or True)
    assert tdata.FeatureDataset(d, log=logs.append).collation == "numpy"
    assert logs == [f"feature collation for {d}: numpy, np.load (no "
                    "utt2num_frames/utt2num_spk)"]
    assert asked == []


def _run(code, env=None):
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "PYTHONPATH": REPO,
           **(env or {})}
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)


def test_sepsep_native_0_turns_it_off(tmp_path):
    d = _feature_dir(str(tmp_path / "d"))
    code = ("from speech_separation_tpu_torch.utils import native\n"
            "from speech_separation_tpu_torch.train.data import FeatureDataset\n"
            "assert not native.available() and native.read_wav_f32('x.wav') is None\n"
            "print(native.status())\n"
            f"print(FeatureDataset({d!r}, log=lambda *_: None).collation)\n")
    out = _run(code, {"SEPSEP_NATIVE": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["not available: turned off (SEPSEP_NATIVE=0)",
                                          "numpy"]


def test_two_processes_build_the_library_at_once(tmp_path):
    """Both wait for a go file, then build csrc/sepio.cpp into one empty
    build dir: each loads a whole library, one .so is left, no temporary."""
    build_dir, go = tmp_path / "build", tmp_path / "go"
    code = ("import os, sys, time\n"
            "from pathlib import Path\n"
            "from speech_separation_tpu_torch.ops import _build\n"
            f"_build.BUILD_DIR = Path({str(build_dir)!r})\n"
            f"while not os.path.exists({str(go)!r}):\n"
            "    time.sleep(0.01)\n"
            "lib = _build.library('sepio')\n"
            "assert lib.sepio_npz_members is not None\n"
            "print(os.path.basename(lib._name))\n")
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
             for _ in range(2)]
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1 and sorted(os.listdir(build_dir)) == sorted(names)
