"""CLI of the PyTorch port: the reference's staged recipe, training and
serving.

Run as ``python -m speech_separation_tpu_torch.cli.main <subcommand>``. The
subcommands and flags are those of the JAX package's CLI
(speech_separation_tpu/cli/main.py), all 21: ``prepare``, ``validate``,
``split``, ``extract``, ``pack-features``, ``train``, ``eval-masks``,
``reconstruct``, ``stage-data``, ``separate``, ``serve``, ``score``,
``oracle`` (the oracle-mask upper bound), ``run-train``, ``run-eval``, the
checkpoint tools ``info``, ``import-model`` and ``export-model``, and the
tools ``doctor`` (the card, nvcc, the kernel builds and the native loader),
``warmup`` (each arch's kernels built and their launch plans checked at its
shapes) and ``bench`` (speech_separation_tpu_torch/bench.py, one JSON
line). ``pack-features``, or ``--pack-cache`` (``--cache-dtype float16``
for half the bytes) on ``extract`` and ``run-train``, packs the training
features into one flat cache that training then reads
(train/feature_cache.py). ``train`` and ``run-train`` take
``--hang-watchdog-sec`` / ``--hang-first-timeout-sec`` (training in a
supervised child, restarted from the newest checkpoint when it stops
beating; train/watchdog.py), ``--profile-dir`` (a torch.profiler trace of
the steps after the first), ``--train-copy-location`` (the features staged
there first) and draw the reference's plots unless ``--no-plots`` (or
matplotlib is missing). Every flag of the JAX CLI parses. ``--data-parallel``
on ``separate``, ``serve``, ``score``, ``oracle`` and ``run-eval`` splits each
batch or scoring slab over every visible card (parallel/mesh.py; with one
card a note says so and the run is the single-device one), and ``train`` /
``run-train`` train over every visible card when there is more than one, as
the JAX package does. Every command that runs
a model or a kernel takes ``--device`` (default ``cuda``; without a card it
fails; ``cpu`` runs the plain PyTorch versions of the kernels).
``--device-scoring`` on ``score``, ``oracle`` and ``run-eval`` runs BSS-eval
in float64 on that device (eval/bss_eval_device.py), held to the host
scorer.

The recipe (the reference's run_train.sh / run_eval.sh): ``run-train`` does
prepare (stage 0), extract (1) and train (2) into ``exp/<arch>_<train-set>``;
``run-eval`` does prepare (0), extract (1), masks (2), reconstruct (3) and
BSS-eval scoring (4) into ``<model-dir>/output_<model>/<set>``, or with
``--on-device-features`` separates the wavs in one pass in place of stages
1-3. The archs are uPIT, RSH and TCN (npz features, or
``--on-device-features``; RSH's batches hold one speaker count each, or with
``--reference-batching`` the reference's mixed batches) and SepFormer, DPRNN
and Conv-TasNet (waveforms only). An RSH model separates each test utterance
into as many sources as its ``utt2num_spk`` says. ``serve
--streaming-model`` adds the live-stream protocol with a causal TCN or
Conv-TasNet (eval/streaming.py). Models are ``.mdl`` state dicts: ``train`` writes
them with the arch and model config in the ``.state`` beside each, which the
evaluation commands read. The evaluation commands also read the JAX
package's own checkpoints (``SEPTPU01``, any arch) and a reference's bare
``.mdl``; ``import-model`` writes either as a port checkpoint and
``export-model`` writes a uPIT/RSH model as a reference ``.mdl``, all
without JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import time


def read_model_config(path: str) -> dict:
    """key=value-per-line model config."""
    kwargs = {}
    if path:
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if line and "=" in line:
                    k, _, v = line.partition("=")
                    kwargs[k] = v
    return kwargs


def _registry(args):
    from ..datadir.registry import DatasetRegistry
    return DatasetRegistry.load(args.registry or os.path.join(args.id_lists_dir, "path.json"))


def _stft_cfg(args):
    from ..dsp.stft import STFTConfig
    return STFTConfig(n_fft=args.fft_dim, hop=args.step_size, sample_rate=args.sample_rate)


# ---------------------------------------------------------------- data dirs

def cmd_prepare(args):
    from ..datadir.prepare import prepare_data_dir
    out = prepare_data_dir(args.dataset, _registry(args), data_root=args.data_root,
                           id_lists_dir=args.id_lists_dir)
    print(f"prepared {out}")


def cmd_validate(args):
    from ..datadir.validate import validate_data_dir
    validate_data_dir(args.data_dir)
    print(f"Data directory {args.data_dir} is OK.")


def cmd_split(args):
    from ..datadir.split import split_data_dir
    print(split_data_dir(args.data_dir, args.num_shards))


def cmd_stage_data(args):
    from ..datadir.stage import stage_scp_data
    stage_scp_data(args.scp, args.target_dir, args.bwlimit or None)


def _in_shards(fn, head: tuple, nj: int, mj: int, **kw) -> None:
    """fn(*head, ".<i>", **kw) for each of nj shards; with mj > 1, mj at once
    in spawned worker processes, each of which opens the card and loads its
    kernels itself (spawn, never fork: the parent may hold an initialized
    CUDA context)."""
    if mj > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(max_workers=mj, mp_context=mp.get_context("spawn")) as pool:
            futures = [pool.submit(fn, *head, f".{i}", **kw) for i in range(1, nj + 1)]
            for f in futures:
                f.result()
    else:
        for i in range(1, nj + 1):
            fn(*head, f".{i}", **kw)


def _extract(data_dir, data_type, feat_dir, args):
    """Extract one data dir's features; with ``--nj N`` in N shards of a
    split dir (then merged), ``--mj M`` of them at once in worker
    processes."""
    from ..datadir.split import split_data_dir
    from ..datadir.validate import validate_data_dir
    from ..dsp.extract import extract_features, merge_shard_outputs
    from ..utils.device import resolve_device
    resolve_device(args.device)          # no card: fail before any shard is written
    cfg = _stft_cfg(args)
    kw = {"compress": not args.no_compress, "device": args.device}
    if args.nj <= 1:
        extract_features(data_dir, data_type, feat_dir, cfg, **kw)
    else:
        validate_data_dir(data_dir)
        split_dir = split_data_dir(data_dir, args.nj)
        _in_shards(extract_features, (split_dir, data_type, feat_dir, cfg), args.nj,
                   args.mj, **kw)
        merge_shard_outputs(data_dir, split_dir, data_type, args.nj)
    if data_type == "train" and args.pack_cache:      # extract and run-train
        from ..train.feature_cache import pack_features
        pack_features(data_dir, data_type, dtype=args.cache_dtype)


def cmd_extract(args):
    _extract(args.data_dir, args.data_type, args.feat_dir, args)


def cmd_pack_features(args):
    from ..train.feature_cache import pack_features
    pack_features(args.data_dir, args.data_type, cache_path=args.cache_path or None,
                  dtype=args.dtype)


# -------------------------------------------------------------- evaluation

def cmd_eval_masks(args):
    from ..eval.infer import generate_masks
    generate_masks(args.model, args.data_dir, args.out_dir, arch_name=args.arch,
                   model_kwargs=read_model_config(args.model_config),
                   batch_size=args.batch_size, device=args.device)


def cmd_reconstruct(args):
    from ..eval.reconstruct import reconstruct_sources
    reconstruct_sources(args.data_dir, args.exp_dir, hop=args.step_size,
                        sample_rate=args.sample_rate, device=args.device)


def cmd_score(args):
    from ..eval.score import evaluate_sources
    evaluate_sources(args.data_dir, args.exp_dir, num_workers=args.nj,
                     device_scoring=args.device_scoring, device=args.device,
                     mesh=_scoring_mesh(args))


def cmd_oracle(args):
    """Oracle-mask upper bound of a data dir; with ``--nj N`` in N shards of
    a split dir (their outputs moved up and merged), ``--mj M`` of them at
    once in worker processes."""
    from ..datadir.split import split_data_dir
    from ..datadir.validate import validate_data_dir
    from ..utils.device import resolve_device
    from ..eval.oracle import evaluate_oracle, merge_oracle_shards
    resolve_device(args.device)          # no card: fail before any shard is written
    cfg = _stft_cfg(args)
    kw = {"device_scoring": args.device_scoring, "device": args.device,
          "mesh": _scoring_mesh(args)}
    if args.nj > 1:
        validate_data_dir(args.data_dir)
        split_dir = split_data_dir(args.data_dir, args.nj)
        _in_shards(evaluate_oracle, (split_dir, args.hard_mask, cfg), args.nj, args.mj, **kw)
        # the shards read the split dir and write under it: move them up
        kind = "hard" if args.hard_mask else "soft"
        src = os.path.join(split_dir, f"oracle_{kind}_mask_eval")
        dst = os.path.join(args.data_dir, f"oracle_{kind}_mask_eval")
        os.makedirs(dst, exist_ok=True)
        for name in os.listdir(src):
            shutil.move(os.path.join(src, name), os.path.join(dst, name))
        means = merge_oracle_shards(args.data_dir, args.hard_mask, args.nj)
    else:
        evaluate_oracle(args.data_dir, args.hard_mask, cfg, **kw)
        means = merge_oracle_shards(args.data_dir, args.hard_mask, 1)
    print(" ".join(f"oracle mean {k}: {v:.2f}" for k, v in means.items()))


# ------------------------------------------------------------- checkpoints

def cmd_info(args):
    """Inspect a checkpoint (a ``SEPTPU01`` file or a port ``.mdl``): arch,
    hyperparameters, training state."""
    from ..utils.import_reference import checkpoint_info
    print("\n".join(checkpoint_info(args.model)))


def cmd_import_model(args):
    """A reference ``.mdl`` or a ``SEPTPU01`` file -> a port checkpoint."""
    from ..utils.import_reference import import_reference_model
    import_reference_model(args.mdl_path, args.out_path)


def cmd_export_model(args):
    """A port checkpoint or a ``SEPTPU01`` file -> the reference's ``.mdl``."""
    from ..utils.import_reference import export_reference_model
    export_reference_model(args.ckpt_path, args.out_path)


def _data_mesh(args):
    """The mesh of ``--data-parallel``, or None when the flag is off (or
    fewer than two cards are visible, with a note)."""
    if not getattr(args, "data_parallel", False):
        return None
    from ..parallel.mesh import data_parallel_mesh
    return data_parallel_mesh(device=args.device)


def _scoring_mesh(args):
    """The mesh that splits each scoring slab: ``--data-parallel``'s, with
    ``--device-scoring`` only (the host scorer runs on the CPU)."""
    return _data_mesh(args) if args.device_scoring else None


def _pipeline(args):
    from ..eval.pipeline import SeparationPipeline
    return SeparationPipeline(args.model, arch_name=args.arch,
                              model_kwargs=read_model_config(args.model_config),
                              stft_cfg=_stft_cfg(args), batch_size=args.batch_size,
                              num_spk=args.num_spk or None, device=args.device,
                              mesh=_data_mesh(args))


def _separate_via_server(args):
    """Hand the work to a running ``serve`` process: no model load here."""
    from ..eval.serve import request
    # the server's own model/STFT/batch configuration wins; say so instead
    # of silently producing output with other parameters
    ignored = [(f, v) for f, v, d in (
        ("--arch", args.arch, ""),
        ("--model-config", args.model_config, ""),
        ("--batch-size", args.batch_size, 16),
        ("--fft-dim", args.fft_dim, 512),
        ("--step-size", args.step_size, 128),
        ("--sample-rate", args.sample_rate, 8000),
        ("--device", args.device, "cuda"),
        ("--data-parallel", args.data_parallel, False),
    ) if v != d]
    if ignored:
        print("note: --server forwards only wavs/out_dir/num_spk/long-form; "
              "the server's own configuration wins over: "
              + ", ".join(f"{f}={v}" for f, v in ignored))
    payload = {"wavs": [os.path.abspath(w) for w in args.wavs],
               "out_dir": os.path.abspath(args.out_dir)}
    if args.num_spk:
        payload["num_spk"] = args.num_spk
    if args.long_form:
        payload.update(long_form=True, window_sec=args.window_sec,
                       overlap_sec=args.overlap_sec)
    # the server takes seconds to load and bind: wait for the socket
    deadline = time.monotonic() + args.server_wait
    waited = False
    while True:
        try:
            reply = request(args.server, payload)
            break
        except (FileNotFoundError, ConnectionRefusedError) as e:
            if time.monotonic() >= deadline:
                raise SystemExit(f"no server at {args.server} after "
                                 f"{args.server_wait:.0f}s ({e})")
            if not waited:
                print(f"waiting for server at {args.server} ...", flush=True)
                waited = True
            time.sleep(0.5)
    print(json.dumps(reply))
    if not reply.get("ok"):
        raise SystemExit(1)


def cmd_separate(args):
    """Waveforms in, separated waveforms out (the serving path)."""
    if args.server:
        _separate_via_server(args)
        return
    from ..utils.audio import (limit_peak, load_wav, separated_track_paths,
                               wav_num_samples, write_wav_int16)
    pipe = _pipeline(args)
    sr = pipe.stft_cfg.sample_rate
    os.makedirs(args.out_dir, exist_ok=True)

    def write(path, ests):
        for out_path, est in zip(
                separated_track_paths(args.out_dir, path, len(ests)),
                limit_peak(ests)):
            write_wav_int16(out_path, sr, est)

    if args.long_form:
        for path in args.wavs:
            x, _ = load_wav(path, sr=sr)
            write(path, pipe.separate_long(x, window_sec=args.window_sec,
                                           overlap_sec=args.overlap_sec))
    else:
        # audio loads batch by batch, ordered by wav-header lengths
        lengths = [wav_num_samples(p) for p in args.wavs]
        loader = lambda i: load_wav(args.wavs[i], sr=sr)[0]
        for i, ests in pipe.separate_stream(loader, lengths):
            write(args.wavs[i], ests)
    print(f"separated {len(args.wavs)} files -> {args.out_dir}")


def cmd_serve(args):
    """Resident separation server on a Unix socket (newline-JSON protocol,
    eval/serve.py)."""
    from ..eval.serve import SeparationServer
    pipe = _pipeline(args)
    stream_pool = None
    if args.streaming_model:
        from ..eval.streaming import StreamingPool
        stream_pool = StreamingPool(
            args.streaming_model, capacity=args.stream_capacity,
            chunk_frames=args.stream_chunk_frames,
            model_kwargs=read_model_config(args.streaming_model_config),
            n_fft=args.fft_dim, hop=args.step_size, device=args.device)
        print(f"streaming: {args.streaming_model} ({args.stream_capacity} slots, "
              f"{args.stream_chunk_frames}-frame chunks)", flush=True)
    server = SeparationServer(pipe, args.socket_path, coalesce=args.coalesce,
                              stream_pool=stream_pool)

    # SIGTERM and Ctrl-C go through the clean shutdown: in-flight requests
    # drain and the socket file is removed
    def _stop(signum, _frame):
        print(f"signal {signal.Signals(signum).name}: shutting down", flush=True)
        server.shutdown()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    if args.warmup_sec:
        try:
            secs = [float(s) for s in args.warmup_sec.split(",") if s.strip()]
        except ValueError:
            raise SystemExit(f"--warmup-sec expects comma-separated seconds "
                             f"(got {args.warmup_sec!r})")
        n = server.warmup(secs)
        print(f"warmup: {n} shape buckets run", flush=True)
    print(f"serving {args.model} on {args.socket_path} ({pipe.device})", flush=True)
    server.serve_forever()


def _loop_cfg(args):
    from ..train.loop import TrainLoopConfig
    return TrainLoopConfig(
        arch=args.arch, batch_size=args.batch_size, num_epochs=args.num_epochs,
        learning_rate=args.learning_rate, grad_clip=args.grad_clip,
        lr_decay=args.lr_decay, start_epoch=args.start_epoch, seed=args.seed,
        time_pad_multiple=args.time_pad_multiple,
        bucket_by_length=args.bucket_by_length,
        reference_resume=args.reference_resume,
        on_device_features=args.on_device_features,
        reference_batching=args.reference_batching,
        make_plots=not args.no_plots, profile_dir=args.profile_dir,
        train_copy_location=args.train_copy_location)


def _run_training(args, data_dir, exp_dir, cv_data_dir):
    """Training that resumes after a crash, or with ``--hang-watchdog-sec``
    in a supervised child, which also recovers hangs (train/watchdog.py)."""
    kw = {"cv_data_dir": cv_data_dir, "model_kwargs": read_model_config(args.model_config),
          "device": args.device}
    if args.hang_watchdog_sec > 0:
        from ..train.watchdog import train_supervised
        res = train_supervised(data_dir, exp_dir, _loop_cfg(args),
                               hang_timeout_s=args.hang_watchdog_sec,
                               first_timeout_s=args.hang_first_timeout_sec,
                               max_restarts=args.max_restarts, **kw)
        print(f"watchdog: training finished after {res['restarts']} restart(s)")
    else:
        from ..train.loop import train_with_restarts
        train_with_restarts(data_dir, exp_dir, _loop_cfg(args),
                            max_restarts=args.max_restarts, **kw)


def cmd_train(args):
    """Train a separation model on npz features (``feats_train.scp``) or,
    with ``--on-device-features``, on the waveforms of ``wav.scp``."""
    _run_training(args, args.data_dir, args.exp_dir, args.cv_data_dir)


# ----------------------------------------------------------------- recipes

def cmd_run_train(args):
    """The staged training recipe (the reference's run_train.sh)."""
    datasets = [args.train_set] + ([args.cv_set] if args.cv_set else [])
    if args.stage <= 0:
        print("### Preparing data directories (stage 0) ###")
        from ..datadir.prepare import prepare_data_dir
        for ds in datasets:
            prepare_data_dir(ds, _registry(args), data_root=args.data_root,
                             id_lists_dir=args.id_lists_dir)
    if args.stage <= 1:
        if args.on_device_features:
            print("### Skipping feature extraction (on-device features) ###")
        else:
            print("### Extracting features (stage 1) ###")
            for ds in datasets:
                _extract(os.path.join(args.data_root, ds), "train",
                         os.path.join(args.featdir, f"{ds}_train"), args)
    if args.stage <= 2:
        print("### Training model (stage 2) ###")
        from ..models.registry import get_arch
        exp_dir = os.path.join("exp", f"{args.arch}_{args.train_set}")
        os.makedirs(exp_dir, exist_ok=True)
        # snapshot the model config and the arch (its name and source)
        if args.model_config:
            shutil.copy(args.model_config, os.path.join(exp_dir, "conf"))
        arch_mod = get_arch(args.arch)
        with open(os.path.join(exp_dir, "arch.json"), "w") as f:
            json.dump({"arch": arch_mod.NAME, "module": arch_mod.__name__}, f)
        shutil.copy(arch_mod.__file__, os.path.join(exp_dir, "arch.py"))
        cv_dir = os.path.join(args.data_root, args.cv_set) if args.cv_set else ""
        _run_training(args, os.path.join(args.data_root, args.train_set), exp_dir, cv_dir)


def _ensure_utt2num_spk(data_dir: str) -> None:
    """Write utt2num_spk from the corpus layout (the /mix/ -> /*/ glob)
    when no extraction stage wrote it."""
    from ..datadir.scp import read_scp, source_wavs_for_mix, write_utt2num_spk
    path = os.path.join(data_dir, "utt2num_spk")
    if os.path.isfile(path):
        return
    entries = read_scp(os.path.join(data_dir, "wav.scp"))
    write_utt2num_spk(path, ((u, max(len(source_wavs_for_mix(p)) - 1, 1))
                             for u, p in entries))


def _run_eval_fused(args, test_sets, model, model_path, model_config):
    """Stages 1-3 in one pass: the mixtures stream through
    SeparationPipeline.separate_stream (STFT, masks and masked iSTFT on the
    card) into the staged path's wav layout; no feature or mask files. An
    RSH model runs the utterances of each speaker count (``utt2num_spk``) as
    a stream of its own, with that many passes."""
    from ..datadir.scp import read_scp, read_utt2num_spk
    from ..eval.pipeline import SeparationPipeline
    from ..utils.audio import limit_peak, load_wav, wav_num_samples, write_wav_int16
    cfg = _stft_cfg(args)
    pipe = SeparationPipeline(model_path, model_kwargs=read_model_config(model_config),
                              stft_cfg=cfg, batch_size=min(args.batch_size, 32),
                              device=args.device, mesh=_data_mesh(args))
    for ds in test_sets:
        data_dir = os.path.join(args.data_root, ds)
        out_dir = os.path.join(args.model_dir, f"output_{model}", ds)
        entries = read_scp(os.path.join(data_dir, "wav.scp"))
        groups = {None: entries}
        if pipe.arch.NAME == "RSH":
            _ensure_utt2num_spk(data_dir)
            counts = read_utt2num_spk(os.path.join(data_dir, "utt2num_spk"))
            groups = {}
            for e in entries:
                groups.setdefault(counts[e[0]], []).append(e)
        n = 0
        for num_spk, group in groups.items():
            lengths = [wav_num_samples(p) for _, p in group]
            loader = lambda i, group=group: load_wav(group[i][1], sr=cfg.sample_rate)[0]
            for i, ests in pipe.separate_stream(loader, lengths, num_spk):
                # one gain per utterance keeps time-domain tracks inside
                # int16 (BSS-eval is scale-invariant)
                for s, est in enumerate(limit_peak(ests)):
                    path = os.path.join(out_dir, "wav", f"s{s + 1}", group[i][0] + ".wav")
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    write_wav_int16(path, cfg.sample_rate, est)
                n += 1
        print(f"separated {n} mixtures -> {out_dir}/wav")


def _models_to_eval(args):
    """[(label, model path)]: final.mdl, or intermediate model N, or with
    --sweep-intermediates every saved model and final."""
    inter_dir = os.path.join(args.model_dir, "intermediate_models")
    if args.sweep_intermediates:
        models = []
        if os.path.isdir(inter_dir):
            for name in sorted(os.listdir(inter_dir)):
                if name.endswith(".mdl"):
                    epoch = os.path.splitext(name)[0]
                    # the reference's output dirs use the unpadded epoch
                    models.append((str(int(epoch)) if epoch.isdigit() else epoch,
                                   os.path.join(inter_dir, name)))
        final = os.path.join(args.model_dir, "final.mdl")
        if os.path.isfile(final):
            models.append(("final", final))
        if not models:
            raise SystemExit(f"--sweep-intermediates: no models under {args.model_dir}")
        return models
    if args.intermediate_model_num:
        n = int(args.intermediate_model_num)
        return [(args.intermediate_model_num, os.path.join(inter_dir, f"{n:03d}.mdl"))]
    return [("final", os.path.join(args.model_dir, "final.mdl"))]


def _write_sweep_results(model_dir, ds, rows):
    """One table per test set, rows [(label, means)], the best model by
    SDR flagged with '*'."""
    out_dir = os.path.join(model_dir, "sweep_results")
    os.makedirs(out_dir, exist_ok=True)
    best = max(rows, key=lambda r: r[1]["SDR"])[0]
    path = os.path.join(out_dir, f"{ds}.txt")
    keys = ("SDR", "SIR", "SAR", "SI-SDR", "SI-SDRi")
    with open(path, "w") as f:
        f.write("model " + " ".join(keys) + " best\n")
        for label, means in rows:
            vals = " ".join(f"{means[k]:.4f}" for k in keys)
            f.write(f"{label} {vals}{' *' if label == best else ''}\n")
    print(f"{ds}: best model by SDR is {best} -> {path}")
    return best


def cmd_run_eval(args):
    """The staged evaluation recipe (the reference's run_eval.sh)."""
    from ..utils.device import resolve_device
    resolve_device(args.device)          # no card: fail before anything is written
    test_sets = args.test_sets.split()
    model_config = args.model_config
    conf = os.path.join(args.model_dir, "conf")
    if not model_config and os.path.isfile(conf):
        model_config = conf              # the run-train snapshot
    models = _models_to_eval(args)
    fused = args.on_device_features

    if args.stage <= 0:
        print("### Preparing data directories (stage 0) ###")
        from ..datadir.prepare import prepare_data_dir
        for ds in test_sets:
            prepare_data_dir(ds, _registry(args), data_root=args.data_root,
                             id_lists_dir=args.id_lists_dir)
    if not fused and args.stage <= 1:
        print("### Extracting features (stage 1) ###")
        for ds in test_sets:
            _extract(os.path.join(args.data_root, ds), "test",
                     os.path.join(args.featdir, f"{ds}_test"), args)

    results = {ds: [] for ds in test_sets}
    for model, model_path in models:
        tag = f" [{model}]" if args.sweep_intermediates else ""
        out_dirs = {ds: os.path.join(args.model_dir, f"output_{model}", ds) for ds in test_sets}
        if fused:
            if args.stage <= 3:
                print(f"### Fused separation (stages 1-3 combined){tag} ###")
                _run_eval_fused(args, test_sets, model, model_path, model_config)
        else:
            if args.stage <= 2:
                print(f"### Generating masks (stage 2){tag} ###")
                from ..eval.infer import generate_masks
                for ds in test_sets:
                    generate_masks(model_path, os.path.join(args.data_root, ds),
                                   os.path.join(out_dirs[ds], "masks"),
                                   model_kwargs=read_model_config(model_config),
                                   batch_size=args.batch_size, device=args.device)
            if args.stage <= 3:
                print(f"### Generating estimated source wav files (stage 3){tag} ###")
                from ..eval.reconstruct import reconstruct_sources
                for ds in test_sets:
                    reconstruct_sources(os.path.join(args.data_root, ds), out_dirs[ds],
                                        hop=args.step_size, sample_rate=args.sample_rate,
                                        device=args.device)
        if args.stage <= 4:
            print(f"### Evaluating estimated sources (stage 4){tag} ###")
            from ..eval.score import evaluate_sources
            for ds in test_sets:
                data_dir = os.path.join(args.data_root, ds)
                if fused:
                    _ensure_utt2num_spk(data_dir)
                means = evaluate_sources(data_dir, out_dirs[ds], num_workers=args.nj,
                                         device_scoring=args.device_scoring,
                                         device=args.device, mesh=_scoring_mesh(args))
                print(f"{ds} mean SDR: {means['SDR']:.2f}")
                results[ds].append((model, means))

    if args.sweep_intermediates and args.stage <= 4:
        for ds in test_sets:
            _write_sweep_results(args.model_dir, ds, results[ds])


# ------------------------------------------------------------------- tools

def cmd_doctor(args):
    """The card and the toolchain: Python, torch and CUDA versions; the card
    probed in a killable child (name, power limit, device count, a trivial
    op's latency with CUDA's initialisation); nvcc; each kernel source
    built for its current hash or not; the build directory. Exits non-zero
    if the probe fails or hangs, or if nvcc is missing."""
    import platform
    import subprocess

    import torch

    from ..bench import card_name, probe_device
    from ..ops import _build

    ok = True
    print(f"python: {platform.python_version()}")
    print(f"torch: {torch.__version__} (CUDA {torch.version.cuda})")
    probe = probe_device(args.probe_timeout)
    if probe["ok"]:
        try:
            card = card_name()
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            card = f"{probe['name']} (nvidia-smi: {e})"
        print(f"card: {card}; {probe['count']} device(s), trivial-op latency "
              f"{probe['latency_s']}s (incl. init)")
    else:
        ok = False
        print(f"card: PROBE FAILED ({probe['error']})")
    try:
        nvcc = _build._nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout.strip().splitlines()[-1:]
        print(f"nvcc: {nvcc} ({version[0] if version else '?'})")
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        ok = False
        print(f"nvcc: MISSING ({e})")
    for name in _build.SOURCES:
        state = (f"built ({_build._target(name).name})" if _build.is_built(name)
                 else "not built for its current source")
        print(f"kernel {name}.cu: {state}")
    from ..utils import native
    print(f"native io (csrc/sepio.cpp): {native.status()}")
    n = len(os.listdir(_build.BUILD_DIR)) if os.path.isdir(_build.BUILD_DIR) else 0
    print(f"build dir: {_build.BUILD_DIR} ({n} entries)")
    if not ok:
        raise SystemExit(1)


def _time_domain_framing(cfg, seconds: float) -> tuple[int, int]:
    """(latent frames, chunks) of a time-domain arch's utterance of
    ``seconds`` at 8 kHz."""
    from ..models.dual_path import num_chunks
    from ..models.waveform import latent_frames
    n_t = latent_frames(cfg, int(seconds * 8000))
    return n_t, num_chunks(cfg, n_t)


def kernel_plans(arch, cfg, batch_size: int, frames: int, seconds: float) -> list:
    """Each kernel launch plan of the arch's training step at these shapes
    (ops/lstm_kernel.lstm_fwd_plan / lstm_bwd_plan, ops/attention_kernel.
    attention_plan, ops/stft_kernel.stft_plan; the STFT at the
    on-device-features shape), as (what, plan) pairs. Raises ValueError
    for a shape a kernel refuses."""
    from ..ops import attention_kernel, lstm_kernel, stft_kernel
    dt, B, plans = cfg.torch_dtype, batch_size, []
    if arch.NAME in ("uPIT", "RSH"):
        for what, fn in (("lstm_fwd", lstm_kernel.lstm_fwd_plan),
                         ("lstm_bwd", lstm_kernel.lstm_bwd_plan)):
            plans.append((f"{what} H={cfg.hidden}", fn(2, B, cfg.hidden, dt)))
    if arch.NAME == "DPRNN":
        _, C = _time_domain_framing(cfg, seconds)
        for rows in (B * C, B * cfg.chunk):
            for what, fn in (("lstm_fwd", lstm_kernel.lstm_fwd_plan),
                             ("lstm_bwd", lstm_kernel.lstm_bwd_plan)):
                plans.append((f"{what} H={cfg.rnn_hidden} rows={rows}",
                              fn(2, rows, cfg.rnn_hidden, dt)))
    if arch.NAME == "SepFormer":
        _, C = _time_domain_framing(cfg, seconds)
        dh = cfg.channels // cfg.heads
        for rows, T in ((B * C, cfg.chunk), (B * cfg.chunk, C)):
            for backward in (False, True):
                plans.append((f"attention {'bwd' if backward else 'fwd'} T={T}",
                              attention_kernel.attention_plan(rows * cfg.heads, T, dh, dt,
                                                              backward)))
    if arch.NAME in ("uPIT", "RSH", "TCN"):
        n_fft, hop = 512, 128
        plans.append((f"stft n_t={frames}", stft_kernel.stft_plan(
            B, (frames - 1) * hop + n_fft, frames, n_fft, hop)))
    return plans


def cmd_warmup(args):
    """Get each arch ready for its first training step: build the kernel
    sources it launches (models/registry.ARCH_KERNELS; ops/_build caches
    them by source hash, the one cache that outlives a process: torch keeps
    no compiled program across processes) and check each kernel's launch
    plan at the given shapes, so a configuration the kernels refuse fails
    here and not at step 1. One line per arch: ready in N s, cold build or
    cache hit."""
    from ..models.registry import ARCH_KERNELS, ARCHS, get_arch
    from ..ops import _build

    names = [n.strip() for n in args.archs.split(",") if n.strip()] or list(ARCHS)
    model_kwargs = read_model_config(args.model_config)
    for name in names:
        arch = get_arch(name)
        cfg = arch.Config.from_kwargs(**{**model_kwargs, "compute_dtype": args.compute_dtype})
        sources = list(ARCH_KERNELS[arch.NAME])
        t0 = time.time()
        cold = [n for n in sources if not _build.is_built(n)]
        _build.build(sources)
        try:
            plans = kernel_plans(arch, cfg, args.batch_size, args.frames, args.seconds)
        except ValueError as e:
            raise SystemExit(f"warmup {arch.NAME}: the kernels refuse this configuration: {e}")
        status = f"cold build of {', '.join(cold)}" if cold else "cache hit"
        print(f"warmup {arch.NAME}: kernels {sources or 'none'} ready in "
              f"{time.time() - t0:.1f}s ({status}); plans: "
              + ("; ".join(f"{w} {p.get('ctas')} CTAs" for w, p in plans) or "none"),
              flush=True)
    print(f"build cache: {_build.BUILD_DIR}")


def cmd_bench(args):
    """The port's benchmark (speech_separation_tpu_torch/bench.py): one JSON
    line after each phase, the last the full merge; exits non-zero when a
    phase fails or no card is visible."""
    from ..bench import main as bench_main
    rc = bench_main((["--rsh"] if args.rsh else [])
                    + (["--phases", args.phases] if args.phases else []))
    if rc:
        raise SystemExit(rc)


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions "
                        "of the kernels")


def _add_data_parallel(p, help):
    p.add_argument("--data-parallel", action="store_true", help=help)


def _add_device_scoring(p):
    p.add_argument("--device-scoring", action="store_true",
                   help="batched float64 BSS-eval on --device (held to the host "
                        "scorer; utterances its trust gate rejects go to the host)")


def _add_common(p):
    p.add_argument("--data-root", default="data")
    p.add_argument("--id-lists-dir", default="id_lists")
    p.add_argument("--registry", default="",
                   help="dataset registry JSON (default <id-lists-dir>/path.json)")


def _add_stft(p):
    p.add_argument("--fft-dim", type=int, default=512)
    p.add_argument("--step-size", type=int, default=128)
    p.add_argument("--sample-rate", type=int, default=8000)
    p.add_argument("--nj", type=int, default=1,
                   help="number of shards (extraction) and scoring workers")
    p.add_argument("--mj", type=int, default=1,
                   help="shards extracted at once, in worker processes (1 = in-process)")
    p.add_argument("--no-compress", action="store_true",
                   help="write stored (uncompressed) npz features")


def _add_train(p):
    p.add_argument("--model-config", default="")
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--num-epochs", type=int, default=200)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--grad-clip", type=float, default=0.25,
                   help="global-norm gradient clip (the reference's 0.25)")
    p.add_argument("--lr-decay", type=float, default=1.0,
                   help="per-epoch multiplicative lr decay (1.0 = constant)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--time-pad-multiple", type=int, default=128)
    p.add_argument("--bucket-by-length", action="store_true")
    p.add_argument("--reference-resume", action="store_true",
                   help="drop optimizer state on resume, like the reference")
    p.add_argument("--max-restarts", type=int, default=2,
                   help="resume from the newest checkpoint after a crash, up "
                        "to N times")
    p.add_argument("--on-device-features", action="store_true",
                   help="read wav.scp (mix/ with s1/ s2/ beside it) and ship the "
                        "waveforms; the card computes the features, or feeds "
                        "them as they are to a time-domain arch (SepFormer, "
                        "DPRNN), which requires this")
    p.add_argument("--reference-batching", action="store_true",
                   help="RSH: the reference's mixed batches, each shuffled batch "
                        "split into speaker-count sub-batches with gradient "
                        "accumulation and one optimizer step per batch "
                        "(feature files only)")
    p.add_argument("--no-plots", action="store_true",
                   help="draw no loss curves or CV spectrograms (they need matplotlib)")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the steps after the first here")
    p.add_argument("--train-copy-location", default="",
                   help="stage the training features here first (the reference's flag)")
    p.add_argument("--hang-watchdog-sec", type=float, default=0.0,
                   help="train in a supervised child process, killed and restarted "
                        "from the newest checkpoint when no optimizer step, CV batch "
                        "or checkpoint completes for N seconds (a hang, which "
                        "--max-restarts alone cannot see). 0 = off")
    p.add_argument("--hang-first-timeout-sec", type=float, default=2400.0,
                   help="the watchdog's allowance before an attempt's first heartbeat "
                        "(kernel builds and the first batch)")
    _add_device(p)


def _add_pack(p):
    p.add_argument("--pack-cache", action="store_true",
                   help="also pack the training features into one flat cache file")
    p.add_argument("--cache-dtype", default="float32", choices=["float32", "float16"])


def _add_model(p):
    p.add_argument("--arch", default="",
                   help="the model's arch (default: from its .state meta, or a bare "
                        "reference .mdl's weight shapes)")
    p.add_argument("--model-config", default="")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-spk", type=int, default=0)
    p.add_argument("--fft-dim", type=int, default=512)
    p.add_argument("--step-size", type=int, default=128)
    p.add_argument("--sample-rate", type=int, default=8000)
    _add_device(p)


def build_parser():
    ap = argparse.ArgumentParser(prog="speech_separation_tpu_torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("prepare", help="build data/<set>/wav.scp")
    p.add_argument("dataset")
    _add_common(p)
    p.set_defaults(fn=cmd_prepare)

    p = sub.add_parser("validate", help="check data-dir consistency")
    p.add_argument("data_dir")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("split", help="shard a data dir")
    p.add_argument("data_dir")
    p.add_argument("num_shards", type=int)
    p.set_defaults(fn=cmd_split)

    p = sub.add_parser("extract", help="extract STFT features")
    p.add_argument("data_dir")
    p.add_argument("data_type", choices=["train", "test"])
    p.add_argument("feat_dir")
    _add_stft(p)
    _add_pack(p)
    _add_device(p)
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("pack-features",
                       help="pack npz training features into one flat cache file "
                            "(repeated-epoch input at memcpy speed)")
    p.add_argument("data_dir")
    p.add_argument("data_type", choices=["train"])
    p.add_argument("--cache-path", default="")
    p.add_argument("--dtype", default="float32", choices=["float32", "float16"])
    p.set_defaults(fn=cmd_pack_features)

    p = sub.add_parser("train", help="train a separation model")
    p.add_argument("arch")
    p.add_argument("data_dir")
    p.add_argument("exp_dir")
    p.add_argument("--cv-data-dir", default="")
    _add_train(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval-masks", help="generate masks for a test set")
    p.add_argument("model")
    p.add_argument("data_dir")
    p.add_argument("out_dir")
    p.add_argument("--arch", default="")
    p.add_argument("--model-config", default="")
    p.add_argument("--batch-size", type=int, default=100)
    _add_device(p)
    p.set_defaults(fn=cmd_eval_masks)

    p = sub.add_parser("reconstruct", help="masked iSTFT -> wavs")
    p.add_argument("data_dir")
    p.add_argument("exp_dir")
    p.add_argument("--step-size", type=int, default=128)
    p.add_argument("--sample-rate", type=int, default=8000)
    _add_device(p)
    p.set_defaults(fn=cmd_reconstruct)

    p = sub.add_parser("stage-data", help="copy scp-referenced files to fast local storage")
    p.add_argument("scp")
    p.add_argument("target_dir")
    p.add_argument("--bwlimit", type=float, default=0, help="KiB/s cap (0 = none)")
    p.set_defaults(fn=cmd_stage_data)

    p = sub.add_parser("separate", help="waveform->waveforms separation")
    p.add_argument("model")
    p.add_argument("out_dir")
    p.add_argument("wavs", nargs="+")
    _add_model(p)
    p.add_argument("--long-form", action="store_true",
                   help="window + permutation-align + crossfade (for "
                        "minutes-long recordings)")
    p.add_argument("--window-sec", type=float, default=8.0)
    p.add_argument("--overlap-sec", type=float, default=1.0)
    p.add_argument("--server", default="",
                   help="socket of a running `serve` process: send the "
                        "request there instead of loading the model")
    p.add_argument("--server-wait", type=float, default=60.0,
                   help="seconds to wait for the server socket to appear")
    _add_data_parallel(p, "shard each batch over all visible devices (params "
                          "replicated); batch-size is rounded up to a device multiple")
    p.set_defaults(fn=cmd_separate)

    p = sub.add_parser("serve", help="resident separation server (warm model "
                                     "on a Unix socket; JSON-line protocol)")
    p.add_argument("model")
    p.add_argument("socket_path")
    _add_model(p)
    p.add_argument("--coalesce", type=int, default=32,
                   help="max queued requests merged into one device batch")
    p.add_argument("--streaming-model", default="",
                   help="causal .mdl (TCN or Conv-TasNet) enabling the live-stream "
                        "protocol (stream_open/push/close, eval/serve.py)")
    p.add_argument("--streaming-model-config", default="",
                   help="key=value config for the streaming model")
    p.add_argument("--stream-capacity", type=int, default=8,
                   help="max concurrent live streams (one batched chunk program)")
    p.add_argument("--stream-chunk-frames", type=int, default=16,
                   help="chunk size in frames: STFT frames (TCN; latency = chunk + "
                        "n_fft/2 samples) or encoder frames (Conv-TasNet)")
    p.add_argument("--warmup-sec", default="",
                   help="comma-separated audio lengths (seconds) to run "
                        "once at startup, e.g. '4,8'")
    _add_data_parallel(p, "shard each device batch over all visible devices (params "
                          "replicated); batch-size is rounded up to a device multiple")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("score", help="BSS-eval + SI-SDR scoring (float64; host, or "
                                     "the card with --device-scoring)")
    p.add_argument("data_dir")
    p.add_argument("exp_dir")
    p.add_argument("--nj", type=int, default=0, help="scoring worker processes")
    _add_device_scoring(p)
    _add_data_parallel(p, "(with --device-scoring) shard each scoring slab over all "
                          "visible devices")
    _add_device(p)
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("oracle", help="oracle-mask upper bound eval")
    p.add_argument("data_dir")
    p.add_argument("--hard-mask", action="store_true")
    _add_device_scoring(p)
    _add_data_parallel(p, "(with --device-scoring) shard each scoring slab over all "
                          "visible devices")
    _add_stft(p)
    _add_device(p)
    p.set_defaults(fn=cmd_oracle)

    p = sub.add_parser("info", help="inspect a checkpoint (arch, hyperparameters, state)")
    p.add_argument("model")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("import-model",
                       help="convert a reference torch .mdl or the JAX package's "
                            "checkpoint into a port checkpoint (.mdl and .state)")
    p.add_argument("mdl_path")
    p.add_argument("out_path")
    p.set_defaults(fn=cmd_import_model)

    p = sub.add_parser("export-model",
                       help="convert a port checkpoint or the JAX package's checkpoint "
                            "(uPIT/RSH) into a reference torch .mdl state-dict")
    p.add_argument("ckpt_path")
    p.add_argument("out_path")
    p.set_defaults(fn=cmd_export_model)

    p = sub.add_parser("run-train", help="staged training recipe")
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--arch", default="uPIT")
    p.add_argument("--train-set", required=True)
    p.add_argument("--cv-set", default="")
    p.add_argument("--featdir", default="feats")
    _add_common(p)
    _add_stft(p)
    _add_pack(p)
    _add_train(p)
    p.set_defaults(fn=cmd_run_train)

    p = sub.add_parser("run-eval", help="staged evaluation recipe")
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--model-dir", required=True)
    p.add_argument("--test-sets", required=True, help="space-separated dataset names")
    p.add_argument("--intermediate-model-num", default="")
    p.add_argument("--sweep-intermediates", action="store_true",
                   help="evaluate every saved model (intermediate epochs and "
                        "final); writes sweep_results/<set>.txt with the best "
                        "model by SDR flagged")
    p.add_argument("--model-config", default="")
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--featdir", default="feats")
    p.add_argument("--on-device-features", action="store_true",
                   help="fused wav->wav separation (no feature or mask files)")
    _add_device_scoring(p)
    _add_data_parallel(p, "shard device batches over all visible devices (applies to "
                          "--on-device-features separation and --device-scoring)")
    _add_common(p)
    _add_stft(p)
    _add_device(p)
    p.set_defaults(fn=cmd_run_eval)

    p = sub.add_parser("doctor", help="the card (probed in a killable child), nvcc and "
                                      "the kernel builds")
    p.add_argument("--probe-timeout", type=float, default=60.0,
                   help="seconds before declaring the card's probe hung")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("bench", help="reference-scale benchmark on the card (one JSON "
                                     "line; speech_separation_tpu_torch/bench.py)")
    p.add_argument("--rsh", action="store_true",
                   help="measure the RSH full train step instead of the phases")
    p.add_argument("--phases", default="",
                   help="comma list of phases (default all ten, in bench.PHASES order)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("warmup", help="build each arch's kernels and check their launch "
                                      "plans at the given shapes")
    p.add_argument("--archs", default="",
                   help="comma-separated arch names (default: all registered)")
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--frames", type=int, default=384,
                   help="padded frame count for spectral archs")
    p.add_argument("--seconds", type=float, default=4.0,
                   help="utterance length for time-domain archs")
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--model-config", default="",
                   help="key=value file of model hyperparameters")
    p.set_defaults(fn=cmd_warmup)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
