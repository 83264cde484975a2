"""The port's staged eval chain against the JAX package's on the CPU: feature
extraction (dsp/extract.py), mask inference (eval/infer.generate_masks),
reconstruction (eval/reconstruct.py), the host BSS-eval scorer
(eval/bss_eval.py) and scoring (eval/score.py). The corpus is the JAX
package's synthetic one (6 utterances of 0.6-1.4 s); the model is a JAX
uPIT (hidden 16, 1 layer, zero initial state) saved with save_checkpoint
and exported to a reference .mdl with state_dict_from_params, as in
tests/test_torch_pipeline.py. Kernels run through their plain versions.

Tolerances:
- extraction: the same npz keys, dtypes and shapes; values within 1e-5 x
  max|X| of the utterance's array (K2's contract); feats_*.scp (paths
  aside), utt2num_spk and utt2num_frames identical;
- masks: the same keys and (F, T) shapes; values atol 1e-5 (f32); a row's
  masks do not depend on its batch: atol 1e-6 between batch sizes;
- reconstruction from the same mask npz: int16 samples within 1 LSB;
- bss_eval_sources, si_sdr: within 1e-9 dB of the JAX scorer; the
  golden vectors within tests/test_bss_eval_golden.py's own 1e-3 dB;
- evaluate_sources on one wav dir: every result file byte-identical;
- eval-masks refuses RSH for a uPIT model's weights and a time-domain
  arch, writing nothing.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from speech_separation_tpu.datadir import DatasetRegistry, prepare_data_dir, split_data_dir
from speech_separation_tpu.dsp import STFTConfig as JaxSTFTConfig
from speech_separation_tpu.dsp import extract as jextract
from speech_separation_tpu.eval import bss_eval as jbss
from speech_separation_tpu.eval.infer import generate_masks as jax_generate_masks
from speech_separation_tpu.eval.reconstruct import reconstruct_sources as jax_reconstruct
from speech_separation_tpu.eval.score import evaluate_sources as jax_evaluate
from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu.train.checkpoint import save_checkpoint
from speech_separation_tpu.utils.import_torch import state_dict_from_params
from speech_separation_tpu.utils.synthetic import make_synthetic_corpus, write_id_list
from speech_separation_tpu_torch.dsp import extract as textract
from speech_separation_tpu_torch.eval import bss_eval as tbss
from speech_separation_tpu_torch.eval.infer import generate_masks
from speech_separation_tpu_torch.eval.reconstruct import reconstruct_sources
from speech_separation_tpu_torch.eval.score import evaluate_sources
from speech_separation_tpu_torch.utils.audio import load_wav

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = {"hidden": "16", "num_layers": "1", "zero_init_hidden": "1"}
REL_TOL = 1e-5
MASK_ATOL = 1e-5


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval_chain")
    corpus = str(root / "corpus")
    ids = make_synthetic_corpus(corpus, 6, seed=1, prefix="tt")
    write_id_list(str(root / "id_lists"), "toy", ids)
    data_dir = prepare_data_dir("toy", DatasetRegistry({"toy": corpus}),
                                data_root=str(root / "data"),
                                id_lists_dir=str(root / "id_lists"))
    with open(os.path.join(data_dir, "segments"), "w") as f:
        for utt in ids[:3]:
            f.write(f"{utt}-a {utt} 0.00 0.31\n{utt}-b {utt} 0.31 0.55\n")

    cfg = jupit.Config(feat_dim=257, num_spk=2, hidden=16, num_layers=1,
                       zero_init_hidden=True)
    params, state = jupit.init(jax.random.PRNGKey(3), cfg)
    ckpt = str(root / "model.ckpt")
    save_checkpoint(ckpt, params=params, state=state, epoch=0, meta={"arch": "uPIT"})
    mdl = str(root / "model.mdl")
    sd = state_dict_from_params(jax.device_get(params), jax.device_get(state))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, mdl)

    # the test features every later stage reads: the port's, no segments
    test_dir = str(root / "test_data")
    os.makedirs(test_dir)
    shutil.copy(os.path.join(data_dir, "wav.scp"), test_dir)
    textract.extract_features(test_dir, "test", str(root / "feats_test"), log=quiet,
                              device="cpu")
    return {"root": root, "data_dir": data_dir, "test_dir": test_dir, "ids": ids,
            "ckpt": ckpt, "mdl": mdl}


def _copy_dir(src, dst, segments):
    os.makedirs(dst)
    shutil.copy(os.path.join(src, "wav.scp"), dst)
    if segments:
        shutil.copy(os.path.join(src, "segments"), dst)
    return dst


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("data_type,layout", [("train", "plain"), ("test", "plain"),
                                              ("train", "segments"), ("test", "shard")])
def test_extract_matches_jax(chain, tmp_path, data_type, layout):
    dirs = {}
    for name, extract, kw in (("j", jextract.extract_features, {}),
                              ("t", textract.extract_features, {"device": "cpu"})):
        d = _copy_dir(chain["data_dir"], str(tmp_path / f"data_{name}"), layout == "segments")
        suffix = ""
        if layout == "shard":
            d, suffix = split_data_dir(d, 2), ".2"
        extract(d, data_type, str(tmp_path / f"feats_{name}"), JaxSTFTConfig(),
                job_suffix=suffix, log=quiet, **kw)
        dirs[name] = (d, suffix)
    (dj, suffix), (dt, _) = dirs["j"], dirs["t"]
    for name in ("utt2num_spk", "utt2num_frames"):
        assert _read(os.path.join(dt, name + suffix)) == _read(os.path.join(dj, name + suffix))
    scp = f"feats_{data_type}.scp{suffix}"
    want = [ln.split() for ln in _read(os.path.join(dj, scp)).splitlines()]
    got = [ln.split() for ln in _read(os.path.join(dt, scp)).splitlines()]
    assert [(k, os.path.basename(p)) for k, p in got] == [
        (k, os.path.basename(p)) for k, p in want]
    # segments: two of each of the first three recordings, the others none
    assert len(got) == {"plain": 6, "segments": 3 * 2, "shard": 3}[layout]
    keys = {"train": {"mix", "s1", "s2"}, "test": {"mix"}}[data_type]
    dtype = {"train": np.float32, "test": np.complex64}[data_type]
    for (_, pj), (_, pt) in zip(want, got):
        with np.load(pj) as a, np.load(pt) as b:
            assert set(b.files) == set(a.files) == keys
            for k in keys:
                assert b[k].dtype == a[k].dtype == dtype
                assert b[k].shape == a[k].shape and b[k].shape[0] == 257
                err = np.max(np.abs(b[k] - a[k])) / np.max(np.abs(a[k]))
                assert err <= REL_TOL, (pt, k, err)


def test_generate_masks_matches_jax(chain, tmp_path):
    test_dir = chain["test_dir"]
    out_j, out_t = str(tmp_path / "masks_j"), str(tmp_path / "masks_t")
    jax_generate_masks(chain["ckpt"], test_dir, out_j, model_kwargs=KW, batch_size=4,
                       log=quiet)
    generate_masks(chain["mdl"], test_dir, out_t, model_kwargs=KW, batch_size=4, log=quiet,
                   device="cpu")
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == [
        f"{u}.npz" for u in chain["ids"]]
    for name in os.listdir(out_j):
        with np.load(os.path.join(out_j, name)) as a, np.load(os.path.join(out_t, name)) as b:
            assert sorted(b.files) == sorted(a.files) == ["s1", "s2"]
            for k in a.files:
                assert b[k].dtype == np.float32 and b[k].shape == a[k].shape
                assert b[k].shape[0] == 257
                np.testing.assert_allclose(b[k], a[k], atol=MASK_ATOL, rtol=0)


def test_masks_do_not_depend_on_the_batch(chain, tmp_path):
    """Batches of 4 (the last of 2 real rows and 2 padding rows) against one
    batch of all 6 and batches of 1."""
    outs = {}
    for bs in (6, 4, 1):
        outs[bs] = str(tmp_path / f"m{bs}")
        generate_masks(chain["mdl"], chain["test_dir"], outs[bs], model_kwargs=KW,
                       batch_size=bs, log=quiet, device="cpu")
    for name in os.listdir(outs[6]):
        with np.load(os.path.join(outs[6], name)) as ref:
            for bs in (4, 1):
                with np.load(os.path.join(outs[bs], name)) as got:
                    for k in ref.files:
                        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0)


def test_masks_refuse_rsh_and_time_domain_archs(chain, tmp_path):
    """RSH named for a uPIT model's weights does not fit them (the arch is
    ported since; its masks are held against the JAX package in
    tests/test_torch_rsh.py); a time-domain arch has no masks to write (as
    the JAX package's generate_masks says)."""
    from speech_separation_tpu_torch.models import sepformer
    from speech_separation_tpu_torch.train.checkpoint import save_checkpoint as save_port
    with pytest.raises(ValueError, match="does not fit RSH"):
        generate_masks(chain["mdl"], chain["test_dir"], str(tmp_path / "rsh"),
                       arch_name="RSH", device="cpu")
    kw = {"n_filters": "8", "channels": "8", "heads": "2", "d_ff": "8", "chunk": "4",
          "blocks": "1"}
    mdl = str(tmp_path / "sepformer.mdl")
    save_port(mdl, sepformer.SepFormer(sepformer.Config.from_kwargs(**kw)), epoch=0,
              meta={"arch": "SepFormer", "model_kwargs": kw})
    with pytest.raises(ValueError, match="time-domain"):
        generate_masks(mdl, chain["test_dir"], str(tmp_path / "sf"), device="cpu")
    assert not (tmp_path / "rsh").exists() and not (tmp_path / "sf").exists()


def test_reconstruct_from_the_same_masks_matches_jax(chain, tmp_path):
    exp = {}
    for name in ("j", "t"):
        exp[name] = str(tmp_path / f"exp_{name}")
        generate_masks(chain["mdl"], chain["test_dir"], os.path.join(exp[name], "masks"),
                       model_kwargs=KW, batch_size=6, log=quiet, device="cpu")
    jax_reconstruct(chain["test_dir"], exp["j"], log=quiet)
    reconstruct_sources(chain["test_dir"], exp["t"], log=quiet, device="cpu")
    feats = dict(l.split() for l in _read(os.path.join(chain["test_dir"],
                                                       "feats_test.scp")).splitlines())
    for utt in chain["ids"]:
        n_t = np.load(feats[utt])["mix"].shape[1]
        for s in ("s1", "s2"):
            a = np.round(load_wav(os.path.join(exp["j"], "wav", s, utt + ".wav"))[0] * 32768)
            b, sr = load_wav(os.path.join(exp["t"], "wav", s, utt + ".wav"))
            assert sr == 8000 and len(b) == len(a) == 128 * (n_t - 1)
            assert np.max(np.abs(np.round(b * 32768) - a)) <= 1


def _bss_case(rng, nsrc, L):
    refs = rng.standard_normal((nsrc, L))
    mixing = np.eye(nsrc) + 0.3 * rng.standard_normal((nsrc, nsrc))
    ests = mixing @ refs + 0.05 * rng.standard_normal((nsrc, L))
    return refs, ests[::-1].copy()


@pytest.mark.parametrize("nsrc,perm", [(2, True), (2, False), (3, False)])
def test_bss_eval_and_si_sdr_match_jax(nsrc, perm):
    rng = np.random.default_rng(nsrc * 10 + perm)
    refs, ests = _bss_case(rng, nsrc, 700)
    want = jbss.bss_eval_sources(refs, ests, compute_permutation=perm)
    got = tbss.bss_eval_sources(refs, ests, compute_permutation=perm)
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, atol=1e-9, rtol=0)
    mix = refs.sum(0)
    for k in range(nsrc):
        assert abs(tbss.si_sdr(ests[k], refs[k]) - jbss.si_sdr(ests[k], refs[k])) <= 1e-9
        assert abs(tbss.si_sdr_improvement(ests[k], refs[k], mix)
                   - jbss.si_sdr_improvement(ests[k], refs[k], mix)) <= 1e-9


def test_bss_eval_golden_vectors():
    """tests/golden/bss_eval_golden.npz, read as tests/test_bss_eval_golden.py
    reads it, at its 1e-3 dB (values past 100 dB are roundoff, clipped)."""
    data = np.load(os.path.join(REPO, "tests", "golden", "bss_eval_golden.npz"))
    for name in ["ar2", "ar3", "filtered", "tones", "identity_noperm"]:
        sdr, sir, sar, popt = tbss.bss_eval_sources(
            data[f"{name}_refs"], data[f"{name}_ests"],
            compute_permutation=bool(data[f"{name}_perm_flag"]))
        np.testing.assert_array_equal(popt, data[f"{name}_popt"])
        for metric, got in (("sdr", sdr), ("sir", sir), ("sar", sar)):
            np.testing.assert_allclose(np.minimum(got, 100.0),
                                       np.minimum(data[f"{name}_{metric}"], 100.0),
                                       atol=1e-3, err_msg=f"{name}/{metric}")


def test_evaluate_sources_writes_the_jax_result_files(chain, tmp_path):
    """The same wav dir (3 utterances) scored by the JAX host path and by the
    port, in process and with two spawned workers."""
    data = str(tmp_path / "data3")
    os.makedirs(data)
    for name in ("wav.scp", "utt2num_spk", "feats_test.scp"):
        lines = _read(os.path.join(chain["test_dir"], name)).splitlines(keepends=True)
        with open(os.path.join(data, name), "w") as f:
            f.writelines(lines[:3])
    src = str(tmp_path / "exp_src")
    generate_masks(chain["mdl"], data, os.path.join(src, "masks"), model_kwargs=KW,
                   batch_size=3, log=quiet, device="cpu")
    reconstruct_sources(data, src, log=quiet, device="cpu")
    results = {}
    for name, fn in (("j", lambda d: jax_evaluate(data, d, log=quiet)),
                     ("t", lambda d: evaluate_sources(data, d, log=quiet)),
                     ("t2", lambda d: evaluate_sources(data, d, num_workers=2, log=quiet))):
        d = str(tmp_path / f"exp_{name}")
        shutil.copytree(os.path.join(src, "wav"), os.path.join(d, "wav"))
        means = fn(d)
        res = os.path.join(d, "results")
        results[name] = {f: _read(os.path.join(res, f)) for f in os.listdir(res)}
        assert set(means) == {"SDR", "SIR", "SAR", "SI-SDR", "SI-SDRi"}
    assert len(results["j"]) == 5 * 3 + 1
    assert results["j"]["session_SDRs.txt"].count("\n") == 3
    assert results["t"] == results["j"]
    assert results["t2"] == results["j"]
