"""The port's data-dir layer (speech_separation_tpu_torch/datadir) and
synthetic corpus (utils/synthetic.py) against the JAX package's on the same
inputs: scp, utt2num_spk and segments IO, the registry and its
SEPSEP_WAV_DIR_<SET> override, prepare (plain and combo*), validate (good
and broken dirs), split (with segments), stage, and the CLI's data-dir
subcommands.

Tolerance: none. Every file written is byte-identical to the JAX
package's; every value read or raised is equal.
"""

import os

import pytest
import torch

from speech_separation_tpu.datadir import prepare as jprepare
from speech_separation_tpu.datadir import registry as jregistry
from speech_separation_tpu.datadir import scp as jscp
from speech_separation_tpu.datadir import split as jsplit
from speech_separation_tpu.datadir import stage as jstage
from speech_separation_tpu.datadir import validate as jvalidate
from speech_separation_tpu.utils import synthetic as jsynth
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.datadir import prepare as tprepare
from speech_separation_tpu_torch.datadir import registry as tregistry
from speech_separation_tpu_torch.datadir import scp as tscp
from speech_separation_tpu_torch.datadir import split as tsplit
from speech_separation_tpu_torch.datadir import stage as tstage
from speech_separation_tpu_torch.datadir import validate as tvalidate
from speech_separation_tpu_torch.utils import synthetic as tsynth

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_scp_utt2num_spk_and_segments_io(tmp_path):
    entries = [("u2", "/x/mix/u2.wav"), ("u1", "/x/mix/u1 b.wav")]
    for name, mod in (("j", jscp), ("t", tscp)):
        mod.write_scp(str(tmp_path / name / "wav.scp"), entries)
        mod.write_utt2num_spk(str(tmp_path / name / "utt2num_spk"), {"u2": 2, "u1": 3})
        mod.write_utt2num_spk(str(tmp_path / name / "utt2num_spk.list"), [("u1", 1)])
    assert _tree(tmp_path / "j") == _tree(tmp_path / "t")
    for path in ("wav.scp", "utt2num_spk"):
        p = str(tmp_path / "j" / path)
        assert tscp.read_scp(p) == jscp.read_scp(p)
    p = str(tmp_path / "j" / "utt2num_spk")
    assert tscp.read_utt2num_spk(p) == jscp.read_utt2num_spk(p) == {"u2": 2, "u1": 3}
    seg = tmp_path / "segments"
    seg.write_text("a-1 a 0.00 0.50\n\nb-1 b 0.1 0.9\na-2 a 0.50 1.25\n")
    assert tscp.read_segments(str(seg)) == jscp.read_segments(str(seg))


def test_registry_and_env_override(tmp_path, monkeypatch):
    path = tmp_path / "path.json"
    path.write_text('{"toy": "/corpora/toy", "wsj_tr": "/old/wsj"}')
    monkeypatch.setenv("SEPSEP_WAV_DIR_WSJ_TR", "/corpora/wsj/tr")
    j, t = jregistry.DatasetRegistry.load(str(path)), tregistry.DatasetRegistry.load(str(path))
    assert t.datasets() == j.datasets()
    for ds in ("toy", "wsj_tr"):
        assert t.wav_root(ds) == j.wav_root(ds) and t.mix_dir(ds) == j.mix_dir(ds)
    assert t.wav_root("wsj_tr") == "/corpora/wsj/tr"
    assert tregistry.COMBO_SOURCE_SETS == jregistry.COMBO_SOURCE_SETS
    assert tregistry.KNOWN_DATASETS == jregistry.KNOWN_DATASETS
    with pytest.raises(KeyError) as je:
        j.wav_root("nope")
    with pytest.raises(KeyError) as te:
        t.wav_root("nope")
    assert str(te.value) == str(je.value)


def _prepare_all(mod, reg_mod, tmp_path, root):
    """Prepare a plain set, every combo constituent and a combo set; the
    combo set is first asked for before its constituents exist."""
    sets = reg_mod.COMBO_SOURCE_SETS
    ids = tmp_path / "id_lists"
    reg = reg_mod.DatasetRegistry({s: f"/corpora/{s}" for s in sets + ("toy",)})
    data_root = str(tmp_path / root)
    with pytest.raises(FileNotFoundError):
        mod.prepare_data_dir("combo_x", reg, data_root=data_root, id_lists_dir=str(ids))
    for s in ("toy",) + sets:
        mod.prepare_data_dir(s, reg, data_root=data_root, id_lists_dir=str(ids))
    mod.prepare_data_dir("combo_x", reg, data_root=data_root, id_lists_dir=str(ids))
    return _tree(data_root)


def test_prepare_plain_and_combo_sets(tmp_path):
    ids = tmp_path / "id_lists"
    ids.mkdir()
    (ids / "toy.txt").write_text("utt_b\nutt_a\n\n")
    for s in jregistry.COMBO_SOURCE_SETS:
        (ids / f"{s}.txt").write_text(f"{s}_u0\n{s}_u1\n")
    (ids / "combo_x.txt").write_text(
        f"{jregistry.COMBO_SOURCE_SETS[3]}_u1\n{jregistry.COMBO_SOURCE_SETS[0]}_u0\n")
    want = _prepare_all(jprepare, jregistry, tmp_path, "data_j")
    got = _prepare_all(tprepare, tregistry, tmp_path, "data_t")
    assert got == want and len(got) == 7
    assert got["combo_x/wav.scp"].decode().count("\n") == 2


@pytest.mark.parametrize("case", ["good", "reordered", "missing_key", "extra_key",
                                  "segments", "segments_mismatch", "no_wav_scp", "bad_feats"])
def test_validate_good_and_broken_dirs(tmp_path, case):
    d = tmp_path / "d"
    d.mkdir()
    if case != "no_wav_scp":
        (d / "wav.scp").write_text("u1 /x/mix/u1.wav\nu2 /x/mix/u2.wav\n")
    files = {
        "good": {"utt2num_spk": "u1 2\nu2 2\n", "feats_train.scp": "u1 a\nu2 b\n"},
        "reordered": {"utt2num_spk": "u2 2\nu1 2\n"},
        "missing_key": {"utt2num_spk": "u1 2\n"},
        "extra_key": {"utt2spk": "u1 a\nu2 b\nu3 c\n"},
        "segments": {"segments": "u1-a u1 0 1\nu2-a u2 0 1\n",
                     "feats_test.scp": "u1-a x\nu2-a y\n"},
        "segments_mismatch": {"segments": "u1-a u1 0 1\n"},
        "no_wav_scp": {},
        "bad_feats": {"feats_test.scp": "u1 x\nWRONG y\n"},
    }[case]
    for name, text in files.items():
        (d / name).write_text(text)
    outcome = []
    for mod in (jvalidate, tvalidate):
        try:
            mod.validate_data_dir(str(d))
            outcome.append("ok")
        except mod.DataDirError as e:
            outcome.append(str(e))
        assert mod.is_valid_data_dir(str(d)) == (outcome[-1] == "ok")
    assert outcome[1] == outcome[0]
    assert (outcome[0] == "ok") == (case in ("good", "reordered", "segments"))


@pytest.mark.parametrize("n_rows,n_shards", [(10, 3), (7, 7), (5, 2)])
def test_split_with_segments(tmp_path, n_rows, n_shards):
    lines = "".join(f"r{i:02d} /x/mix/r{i:02d}.wav\n" for i in range(n_rows))
    segs = "".join(f"r{i:02d}-{k} r{i:02d} {k}.0 {k + 1}.0\n"
                   for i in range(n_rows) for k in range(1 + i % 3))
    trees = []
    for name, mod in (("j", jsplit), ("t", tsplit)):
        d = tmp_path / name
        d.mkdir()
        (d / "wav.scp").write_text(lines)
        (d / "segments").write_text(segs)
        split_dir = mod.split_data_dir(str(d), n_shards)
        assert split_dir == str(d / f"split{n_shards}")
        trees.append(_tree(split_dir))
    assert trees[1] == trees[0]
    assert len(trees[0]) == 2 * n_shards
    for row in range(n_rows):
        assert tsplit._shard_index(row, n_rows, n_shards) == jsplit._shard_index(
            row, n_rows, n_shards)


def test_stage_copies_and_skips_staged_files(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    entries = []
    for i in range(3):
        p = src / f"f{i}.npz"
        p.write_bytes(bytes(range(i + 5)))
        entries.append((f"u{i}", str(p)))
    scp = str(tmp_path / "feats.scp")
    jscp.write_scp(scp, entries)
    logs = {}
    for name, mod in (("j", jstage), ("t", tstage)):
        target = str(tmp_path / f"stage_{name}")
        msgs = []
        mapping = mod.stage_scp_data(scp, target, log=msgs.append)
        assert mapping == {p: mod.staged_path(p, target) for _, p in entries}
        mod.stage_scp_data(scp, target, log=msgs.append)       # all staged: copies none
        logs[name] = msgs
        assert _tree(target) == {os.path.relpath(p, "/"): open(p, "rb").read()
                                 for _, p in entries}
    assert [m.replace("stage_t", "stage_j") for m in logs["t"]] == logs["j"]
    assert logs["t"][1].startswith("staged 0 files")


def test_synthetic_corpus_is_byte_identical(tmp_path):
    for name, mod in (("j", jsynth), ("t", tsynth)):
        ids = mod.make_synthetic_corpus(str(tmp_path / name / "two"), 3, seed=5, prefix="x")
        ids_var = mod.make_synthetic_corpus_var(str(tmp_path / name / "var"), 4, seed=6,
                                                min_sec=0.2, max_sec=0.4)
        mod.write_id_list(str(tmp_path / name / "id_lists"), "two", ids + ids_var)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    # 3 two-speaker utterances; 4 mixtures of 1, 2, 3, 1 sources; the id list
    assert len(_tree(tmp_path / "t")) == 3 * 3 + (4 + 7) + 1


def test_cli_data_dir_commands(tmp_path, monkeypatch, capsys):
    """prepare, validate, split and stage-data through the port's CLI write
    what the JAX package's functions write."""
    monkeypatch.chdir(tmp_path)
    ids = tsynth.make_synthetic_corpus(str(tmp_path / "corpus"), 3, min_sec=0.1,
                                       max_sec=0.2, seed=0, prefix="c")
    tsynth.write_id_list("id_lists", "toy", ids)
    monkeypatch.setenv("SEPSEP_WAV_DIR_TOY", str(tmp_path / "corpus"))
    main(["prepare", "toy"])
    jprepare.prepare_data_dir("toy", jregistry.DatasetRegistry.load(), data_root="data_j")
    main(["validate", "data/toy"])
    main(["split", "data/toy", "2"])
    jsplit.split_data_dir("data_j/toy", 2)
    assert _tree("data") == _tree("data_j")
    main(["stage-data", "data/toy/wav.scp", "staged"])
    assert len(_tree("staged")) == 3
    out = capsys.readouterr().out
    assert "prepared data/toy" in out and "Data directory data/toy is OK." in out
    (tmp_path / "data" / "toy" / "utt2num_spk").write_text("c0000 2\n")
    with pytest.raises(tvalidate.DataDirError):
        main(["validate", "data/toy"])
