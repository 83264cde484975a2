"""CLI of the PyTorch port: ``train``, ``separate`` and ``serve``.

Run as ``python -m speech_separation_tpu_torch.cli.main <subcommand>``. The
subcommands and flags are those of the JAX package's ``sepsep train``,
``sepsep separate`` and ``sepsep serve`` (speech_separation_tpu/cli/main.py),
without what is not ported yet (``train``: ``--reference-batching``,
``--profile-dir``, ``--train-copy-location`` and the hang watchdog;
``--no-plots`` is accepted and plots are not drawn; ``separate``/``serve``:
``--data-parallel`` and ``--streaming-model``), and with ``--device``
(default ``cuda``; without a card the command fails). The archs are uPIT
(npz features, or ``--on-device-features``) and SepFormer (waveforms:
``train SepFormer <data_dir> <exp_dir> --on-device-features``, ``wav.scp``
input). Models are ``.mdl`` state dicts: ``train`` writes them with the arch
and model config in the ``.state`` beside each, which ``separate``/``serve``
read, and ``sepsep export-model`` turns the JAX package's uPIT/RSH
checkpoints into reference ``.mdl`` files.
"""

from __future__ import annotations

import argparse
import json
import os
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


def _pipeline(args):
    from ..dsp.stft import STFTConfig
    from ..eval.pipeline import SeparationPipeline
    cfg = STFTConfig(n_fft=args.fft_dim, hop=args.step_size,
                     sample_rate=args.sample_rate)
    return SeparationPipeline(args.model,
                              model_kwargs=read_model_config(args.model_config),
                              stft_cfg=cfg, batch_size=args.batch_size,
                              num_spk=args.num_spk or None, device=args.device)


def _separate_via_server(args):
    """Hand the work to a running ``serve`` process: no model load here."""
    from ..eval.serve import request
    # the server's own model/STFT/batch configuration wins; say so instead
    # of silently producing output with other parameters
    ignored = [(f, v) for f, v, d in (
        ("--model-config", args.model_config, ""),
        ("--batch-size", args.batch_size, 16),
        ("--fft-dim", args.fft_dim, 512),
        ("--step-size", args.step_size, 128),
        ("--sample-rate", args.sample_rate, 8000),
        ("--device", args.device, "cuda"),
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
    server = SeparationServer(pipe, args.socket_path, coalesce=args.coalesce)

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


def cmd_train(args):
    """Train a separation model on npz features (``feats_train.scp``) or,
    with ``--on-device-features``, on the waveforms of ``wav.scp``."""
    from ..train.loop import TrainLoopConfig, train_with_restarts
    loop_cfg = TrainLoopConfig(
        arch=args.arch, batch_size=args.batch_size, num_epochs=args.num_epochs,
        learning_rate=args.learning_rate, grad_clip=args.grad_clip,
        lr_decay=args.lr_decay, start_epoch=args.start_epoch, seed=args.seed,
        time_pad_multiple=args.time_pad_multiple,
        bucket_by_length=args.bucket_by_length,
        reference_resume=args.reference_resume,
        on_device_features=args.on_device_features)
    train_with_restarts(args.data_dir, args.exp_dir, loop_cfg,
                        max_restarts=args.max_restarts, cv_data_dir=args.cv_data_dir,
                        model_kwargs=read_model_config(args.model_config),
                        device=args.device)


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions "
                        "of the kernels")


def _add_model(p):
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

    p = sub.add_parser("train", help="train a separation model")
    p.add_argument("arch")
    p.add_argument("data_dir")
    p.add_argument("exp_dir")
    p.add_argument("--cv-data-dir", default="")
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
                        "them as they are to a time-domain arch (SepFormer), "
                        "which requires this")
    p.add_argument("--no-plots", action="store_true",
                   help="accepted for the JAX package's command lines; the "
                        "port draws no plots yet")
    _add_device(p)
    p.set_defaults(fn=cmd_train)

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
    p.set_defaults(fn=cmd_separate)

    p = sub.add_parser("serve", help="resident separation server (warm model "
                                     "on a Unix socket; JSON-line protocol)")
    p.add_argument("model")
    p.add_argument("socket_path")
    _add_model(p)
    p.add_argument("--coalesce", type=int, default=32,
                   help="max queued requests merged into one device batch")
    p.add_argument("--warmup-sec", default="",
                   help="comma-separated audio lengths (seconds) to run "
                        "once at startup, e.g. '4,8'")
    p.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
