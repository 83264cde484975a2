"""The training loop: the reference's recipe, step by step on the card.

The counterpart of speech_separation_tpu/train/loop.py, for every ported
arch. Per batch: forward (the LSTM recurrences of uPIT, RSH and DPRNN, or
SepFormer's attention with ``fused_attention=1``, through the hand-written
training kernels on CUDA; TCN's and Conv-TasNet's convs as PyTorch ops),
loss / norm, backward, global-norm clip at 0.25, Adam(1e-3). RSH's batches hold one speaker count each; with
``reference_batching`` each shuffled batch is split into speaker-count
sub-batches instead, every sub-batch backpropagates its unnormalised total,
and the summed gradient, divided once by the batch's summed norm, takes one
clip and one Adam step (the reference's mixed batches). Input is
npz features (``feats_train.scp``) or, with ``on_device_features``, the
waveforms of ``wav.scp`` (train/wav_data.py), which a time-domain arch
requires; the card turns them into the arch's batch. Kept from the reference
and the JAX package:

- epoch losses are norm-weighted means, appended to
  ``train_stats/train_loss.txt`` / ``cv_loss.txt`` as ``NNN loss`` lines; on
  resume the logs are cut back to epochs <= start_epoch and continued;
- CV every 5 epochs in eval mode (BN running statistics, no update, no
  graph: the inference kernel);
- checkpoints: ``intermediate_models/init.mdl`` at epoch 0, ``NNN.mdl``
  every 5 epochs, ``final.mdl`` at the end (train/checkpoint.py), with the
  optimizer and generator states beside them so a resume is bit-continuous;
  ``reference_resume`` restores the weights only;
- one trainable bias per LSTM direction (utils/weights.fold_lstm_biases).

One loader spans all the epochs (train/data.iter_epochs) and starts before
the model is built, so epoch 1's first batches are collated and copied
while the model is built and checkpointed, and each later epoch's while the
previous epoch ends. The feature batches come from a packed cache, the
native loader or numpy (train/data.py logs which); an f16 cache's batches
cross to the card as f16 and the step upcasts them there. The training
extras, as in the JAX package:

- ``make_plots``: loss curves at each checkpoint and at the end, and the
  first CV batch's spectrograms (utils/plot.py, the reference's file names)
  under ``train_stats/plots/``; without matplotlib one line says so and
  training goes on;
- ``profile_dir``: a torch.profiler trace of steps 2 to ``profile_steps``
  + 1 (the first step, which builds the kernels, is left out), written as
  a Chrome trace with a table of the device time by kernel;
- ``train_copy_location``: the training features staged there first;
- ``heartbeat_file``: touched after every optimizer step, CV batch and
  checkpoint, for the hang watchdog (train/watchdog.py).

Data parallelism, as the JAX package shards every batch over its mesh:
with more than one visible card, or over a given ``mesh`` (tests and
chip_smoke.py give two entries on one device), ``train`` runs one spawned
process a mesh entry (parallel/ranks.py). Each rank collates the whole of
every batch and keeps its rows (``ranks.rows_of``; of RSH's mixed batches,
each sub-batch's), so T is the whole batch's; BN's statistics, the loss's
norm and the gradients are summed over the ranks, and the initial states
drawn for the global batch, so a step computes what one device computes on
the whole batch, up to the order of sums. Rank 0 alone writes the checkpoints, loss files, plots, heartbeat and
profiler trace; ``train`` returns on the caller what it returns on one
device.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from ..models.registry import get_arch
from ..parallel import ranks
from ..parallel.mesh import Mesh, make_mesh
from ..utils import spans
from ..utils.device import disable_tf32, resolve_device
from ..utils.weights import fold_lstm_biases
from .checkpoint import (final_model_path, intermediate_model_path, load_checkpoint,
                         save_checkpoint)
from .data import (BatchPlan, FeatureDataset, collate, collate_mixed_batch, iter_batches,
                   iter_epochs)
from .wav_data import (STFT, WavDataset, audio_to_feature_batch, audio_to_wave_batch,
                       collate_wav_batch)

# the reference's cadence: CV and an intermediate checkpoint every 5 epochs
CV_EVERY = CHECKPOINT_EVERY = 5
# the arrays each kind of collated batch sends to the card
FEATURE_KEYS = ("mix", "sources", "lengths", "row_mask")
AUDIO_KEYS = ("audio", "sample_lengths", "lengths", "row_mask")


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    arch: str = "uPIT"
    batch_size: int = 100
    num_epochs: int = 200
    learning_rate: float = 1e-3
    grad_clip: float = 0.25
    # per-epoch multiplicative lr decay as a staircase (1.0 = constant, the
    # reference's behavior)
    lr_decay: float = 1.0
    start_epoch: int = 0
    seed: int = 0
    time_pad_multiple: int = 128
    bucket_by_length: bool = False
    reference_resume: bool = False  # drop optimizer state on resume, like the reference
    # read wav.scp and ship the waveforms; the card makes the arch's batch
    # (the only input of a time-domain arch)
    on_device_features: bool = False
    # RSH: the reference's mixed batches (speaker-count sub-batches, one
    # optimizer step per batch) in place of one speaker count per batch
    reference_batching: bool = False
    make_plots: bool = True
    # stage the training features here first (the reference's
    # --train-copy-location)
    train_copy_location: str = ""
    # a trace of the steps after the first, up to profile_steps of them
    profile_dir: str = ""
    profile_steps: int = 5
    # touched after every optimizer step, CV batch and checkpoint; set by
    # train/watchdog.train_supervised, not by hand
    heartbeat_file: str = ""


class Optimizer:
    """The reference optimizer: clip by global norm, then Adam(0.9, 0.999,
    1e-8), with an optional per-epoch staircase lr decay.

    The clip follows optax's ``clip_by_global_norm``: gradients are scaled
    by max_norm / norm only when norm >= max_norm (not torch's
    ``clip_grad_norm_``, which always scales by max_norm / (norm + 1e-6)).
    The lr of update k (0-based) is lr * lr_decay ** (k // steps_per_epoch),
    optax's ``exponential_decay(staircase=True)``; without steps_per_epoch
    the lr is constant."""

    def __init__(self, params, cfg: TrainLoopConfig, steps_per_epoch: int | None = None):
        self.params = [p for p in params if p.requires_grad]
        self.adam = torch.optim.Adam(self.params, lr=cfg.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        self.max_norm = cfg.grad_clip
        self.lr0, self.decay = cfg.learning_rate, cfg.lr_decay
        self.steps_per_epoch = steps_per_epoch
        self.count = 0

    def lr(self) -> float:
        if self.decay != 1.0 and self.steps_per_epoch:
            return self.lr0 * self.decay ** (self.count // self.steps_per_epoch)
        return self.lr0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def clip(self) -> torch.Tensor:
        """Clip the gradients in place; returns their global norm before.
        Over a model axis the norm is the logical parameters': the squared
        sums of the split parameters (``model_split``, parallel/mesh.place)
        are summed over the model group, the replicated ones count once, so
        every rank clips by the same norm."""
        held = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in held]
        squares = [torch.sum(torch.square(g)) for g in grads]
        split = [hasattr(p, "model_split") for p in held]
        if any(split):
            total = ranks.model_sum(sum(q for q, s in zip(squares, split) if s)) \
                + sum(q for q, s in zip(squares, split) if not s)
        else:
            total = sum(squares)
        norm = torch.sqrt(total)
        keep = norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        return norm

    def step(self) -> None:
        """Sum the gradients over the data group of parallel ranks
        (parallel/ranks.py), clip, then one Adam update at the schedule's lr
        (over a model axis, on each rank's blocks)."""
        with spans.span("train.optimizer"):
            ranks.reduce_gradients(self.params)
            self.clip()
            for group in self.adam.param_groups:
                group["lr"] = self.lr()
            self.adam.step()
            self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd["adam"])
        self.count = int(sd["count"])


def update_step(arch, model, optimizer: Optimizer, batch: dict,
                generator: torch.Generator):
    """One training step: gradients of loss / norm, clip, Adam; BN's
    running statistics update in the forward. Returns (loss, norm) as
    device scalars, the whole batch's over data-parallel ranks. Under a
    profiler its phases are spans (utils/spans.py): ``train.step`` holding
    ``train.forward`` (the arch's objective inside it as ``train.loss``),
    ``train.backward`` and ``train.optimizer``."""
    with spans.span("train.step"):
        optimizer.zero_grad()
        with spans.span("train.forward"):
            loss, aux = arch.loss_fn(model, batch, generator, True)
        with spans.span("train.backward"):
            loss.backward()
        optimizer.step()
        return ranks.loss_over_ranks(loss.detach()), aux["norm"]


def accumulate_step(arch, model, optimizer: Optimizer, subs: list[dict],
                    generator: torch.Generator):
    """One training step over a mixed batch's speaker-count sub-batches:
    each backpropagates its unnormalised total (BN's running statistics
    moving sub-batch by sub-batch), the summed gradient is divided once by
    the summed norm, then one clip and one Adam update. Returns (loss,
    norm) as device scalars, loss = summed total / summed norm."""
    with spans.span("train.step"):
        optimizer.zero_grad()
        total = norm = 0.0
        for sb in subs:
            with spans.span("train.forward"):
                _, aux = arch.loss_fn(model, sb, generator, True)
            with spans.span("train.backward"):
                aux["total"].backward()
            total = total + aux["total"].detach()
            norm = norm + aux["norm"]
        with torch.no_grad():
            for p in optimizer.params:
                if p.grad is not None:
                    p.grad.div_(norm)
        optimizer.step()
        return ranks.loss_over_ranks(total / norm), norm


def to_device(batch: dict, dev: torch.device, copy_stream=None,
              keys=FEATURE_KEYS) -> dict:
    """The collated arrays named by ``keys`` as tensors on ``dev``, in their
    own dtypes (an f16 cache's batch crosses as f16), plus ``n_real``, the
    utterance ``names`` and ``h2d_bytes``, the bytes copied. With a CUDA
    ``copy_stream`` (the trainer's transfer thread passes one) the arrays
    are pinned and copied on it, so the copy overlaps the kernels of the
    running step; ``_wait_for_copy`` orders it before the step that reads
    it."""
    host = {k: torch.from_numpy(batch[k]) for k in keys}
    if copy_stream is None:
        out = {k: v.to(dev) for k, v in host.items()}
    else:
        with torch.cuda.stream(copy_stream):
            out = {k: v.pin_memory().to(dev, non_blocking=True) for k, v in host.items()}
            out["ready"] = copy_stream.record_event()
    # a rank's rows carry the whole batch's real rows (ranks.rows_of)
    out["n_real"] = batch.get("n_real", int(batch["row_mask"].sum()))
    out["names"] = batch.get("names", [])
    out["h2d_bytes"] = sum(v.nbytes for v in host.values())
    return out


def upcast_features(batch: dict) -> dict:
    """The batch with half-precision features (an f16 cache's) in float32,
    cast on the batch's device: the loss runs in float32, as the JAX
    package's ``_upcast_features``."""
    return {k: v.float() if k in ("mix", "sources") and v.dtype == torch.float16 else v
            for k, v in batch.items()}


def _wait_for_copy(batch: dict) -> dict:
    """Order the batch's side-stream copy before the step's kernels, and
    keep its device buffers from going back to the copy stream's pool before
    the step has read them."""
    ready = batch.pop("ready", None)
    if ready is not None:
        stream = torch.cuda.current_stream(batch["row_mask"].device)
        stream.wait_event(ready)
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(stream)
    return batch


@torch.no_grad()
def eval_step(arch, model, batch: dict, generator: torch.Generator):
    """CV loss of one batch in eval mode: (loss, norm) device scalars, the
    whole batch's over data-parallel ranks."""
    loss, aux = arch.loss_fn(model, batch, generator, False)
    return ranks.loss_over_ranks(loss), aux["norm"]


def _truncate_loss_file(path: str, max_epoch: int) -> list[tuple[int, float]]:
    """Keep only epochs <= max_epoch, rewrite the file, return the history."""
    history = []
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and int(parts[0]) <= max_epoch:
                    history.append((int(parts[0]), float(parts[1])))
        with open(path, "w") as f:
            for ep, loss in history:
                f.write(f"{ep:03d} {loss}\n")
    return history


class ExpDirLocked(RuntimeError):
    pass


class _ExpLock:
    """Concurrent-run guard: two trainers writing one exp dir corrupt the
    checkpoints and loss logs. A lock owned by a dead pid is replaced."""

    def __init__(self, exp_dir: str):
        self.path = os.path.join(exp_dir, ".train.lock")

    def __enter__(self):
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        # the pid is written to a private file first and hard-linked into
        # place: the lock appears with its content, and link() fails
        # atomically if the lock exists
        tmp = f"{self.path}.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(os.getpid()))
        try:
            while True:
                try:
                    os.link(tmp, self.path)
                    return self
                except FileExistsError:
                    pass
                try:
                    pid = int(open(self.path).read().strip())
                except FileNotFoundError:
                    time.sleep(0.05)
                    continue  # released between attempts; retry
                except OSError as e:
                    raise ExpDirLocked(
                        f"{os.path.dirname(self.path)} has a lock file this "
                        f"process cannot read ({e}); refusing to run concurrently") from e
                except ValueError:
                    pid = -1  # unparsable: stale (the content is atomic)
                if pid > 0:
                    try:
                        os.kill(pid, 0)  # raises if the owner is gone
                        live = True
                    except ProcessLookupError:
                        live = False
                    except PermissionError:
                        live = True  # exists under another uid
                    if live:
                        raise ExpDirLocked(
                            f"{os.path.dirname(self.path)} is being trained by live "
                            f"pid {pid}; refusing to run concurrently")
                # stale: steal by rename, which exactly one waiter wins
                steal = f"{self.path}.stale.{os.getpid()}"
                try:
                    os.rename(self.path, steal)
                    os.remove(steal)
                except OSError:
                    pass  # another waiter stole it first; retry the link
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def __exit__(self, *exc):
        try:
            os.remove(self.path)
        except OSError:
            pass


def latest_intermediate_epoch(exp_dir: str) -> int:
    """Highest saved intermediate checkpoint epoch, 0 if none."""
    int_dir = os.path.join(exp_dir, "intermediate_models")
    if not os.path.isdir(int_dir):
        return 0
    epochs = [int(f[:3]) for f in os.listdir(int_dir)
              if f.endswith(".mdl") and f[:3].isdigit()]
    return max(epochs, default=0)


def train_with_restarts(data_dir: str, exp_dir: str, loop_cfg: TrainLoopConfig,
                        max_restarts: int = 0, log=print, **kwargs) -> dict:
    """On a crash, resume from the newest intermediate checkpoint, up to
    max_restarts times."""
    attempt = 0
    cfg = loop_cfg
    while True:
        try:
            return train(data_dir, exp_dir, cfg, log=log, **kwargs)
        except (ExpDirLocked, KeyboardInterrupt):
            raise
        except Exception as e:
            if attempt >= max_restarts:
                raise
            attempt += 1
            resume_from = max(latest_intermediate_epoch(exp_dir), cfg.start_epoch)
            log(f"training crashed ({type(e).__name__}: {e}); "
                f"restart {attempt}/{max_restarts} from epoch {resume_from}")
            cfg = dataclasses.replace(cfg, start_epoch=resume_from)


def train(data_dir: str, exp_dir: str, loop_cfg: TrainLoopConfig,
          cv_data_dir: str = "", model_kwargs: dict | None = None, device=None,
          log=print, mesh: Mesh | None = None) -> dict:
    """Run the training loop on ``device`` (CUDA by default; it raises when
    no card is visible). Returns {'model', 'model_cfg', 'epoch_losses',
    'cv_losses', 'steps', 'epoch_times', 'utts_per_sec'}; steps holds (ms,
    real rows) of each step, the ms on the host clock up to the loss's
    read-back, which waits for the device; epoch_times holds (epoch, wall s,
    summed step s) of each epoch, its wall from the wait for its first batch
    to its last step.

    Data parallel (module docstring) over ``mesh`` when it has more than one
    entry, or, with ``device`` left to the default, over every visible card
    when there is more than one; the returned model is then on the mesh's
    first device and the steps' rows are the whole batch's."""
    if mesh is None and device in (None, "cuda") and torch.cuda.device_count() > 1:
        mesh = make_mesh()
    if mesh is not None and mesh.shape["model"] > 1:
        raise ValueError(f"train() splits batches over a data axis only, not over {mesh.shape}: "
                         "as in the JAX package, no training loop runs a model axis "
                         "(parallel/checks.steps_over_ranks takes one)")
    if mesh is not None and mesh.size > 1:
        with _ExpLock(exp_dir):
            out = ranks.launch(mesh, _train_rank, (data_dir, exp_dir, loop_cfg, cv_data_dir,
                                                   model_kwargs), log=log)
        model = get_arch(loop_cfg.arch).Model(out["model_cfg"])
        fold_lstm_biases(model)
        model.load_state_dict(out["model"])
        out["model"] = model.to(mesh.devices[0])
        return out
    dev = resolve_device(device if mesh is None else mesh.devices[0])
    with _ExpLock(exp_dir):
        return _train_locked(data_dir, exp_dir, loop_cfg, cv_data_dir, model_kwargs,
                             dev, log)


def _train_rank(data_dir, exp_dir, loop_cfg, cv_data_dir, model_kwargs) -> dict:
    """A rank of a data-parallel ``train``: the loop on the rank's device
    and rows; rank 0 logs, and returns the result with the model's state
    dict on the CPU."""
    r = ranks.current()
    out = _train_locked(data_dir, exp_dir, loop_cfg, cv_data_dir, model_kwargs, r.device,
                        print if r.rank == 0 else _quiet)
    out["model"] = {k: v.detach().cpu() for k, v in out["model"].state_dict().items()}
    return out


def _quiet(*_):
    pass


def _train_locked(data_dir, exp_dir, loop_cfg, cv_data_dir, model_kwargs, dev, log):
    arch = get_arch(loop_cfg.arch)
    model_cfg = arch.Config.from_kwargs(**(model_kwargs or {}))
    time_domain = arch.DOMAIN == "time"
    if time_domain and not loop_cfg.on_device_features:
        raise ValueError(
            f"{arch.NAME} is a time-domain architecture: it trains on "
            "waveforms, not spectral feature files. Run with "
            "--on-device-features (wav.scp input; no extraction stage).")
    rsh = arch.NAME == "RSH"
    mixed = rsh and loop_cfg.reference_batching
    if mixed and loop_cfg.on_device_features:
        raise ValueError("reference_batching needs feature-file input (the mixed-batch "
                         "split is a collation rule)")
    meta = {"arch": arch.NAME,
            "model_kwargs": {k: str(v) for k, v in (model_kwargs or {}).items()}}
    for k, v in (model_kwargs or {}).items():
        log(f"modelparam: {k} {v}")
    # f32 products in full f32, as the JAX package's f32 path
    disable_tf32()

    # over data-parallel ranks each keeps its rows of every batch, and rank
    # 0 alone writes files
    r = ranks.current()
    lead = r is None or r.rank == 0
    stats_dir = os.path.join(exp_dir, "train_stats")
    os.makedirs(stats_dir, exist_ok=True)
    loss_file = os.path.join(stats_dir, "train_loss.txt")
    cv_loss_file = os.path.join(stats_dir, "cv_loss.txt")

    plan = BatchPlan(batch_size=loop_cfg.batch_size,
                     time_pad_multiple=loop_cfg.time_pad_multiple,
                     bucket_by_length=loop_cfg.bucket_by_length,
                     group_by_num_spk=rsh and not mixed, seed=loop_cfg.seed)
    if loop_cfg.on_device_features:
        dataset = WavDataset(data_dir)
        cv_dataset = WavDataset(cv_data_dir) if cv_data_dir else None
        keys = AUDIO_KEYS
        to_arch = audio_to_wave_batch if time_domain else audio_to_feature_batch
        prepare = functools.partial(to_arch, cfg=STFT)

        def collate_for(ds):
            return lambda idxs: ranks.rows_of(
                collate_wav_batch(ds, idxs, loop_cfg.batch_size), r)
    else:
        dataset = FeatureDataset(data_dir, copy_location=loop_cfg.train_copy_location,
                                 log=log)
        cv_dataset = FeatureDataset(cv_data_dir, log=log) if cv_data_dir else None
        keys = FEATURE_KEYS
        prepare = upcast_features

        def collate_for(ds):
            if mixed:
                # each speaker-count sub-batch split over the ranks
                return lambda idxs: [ranks.rows_of(sb, r) for sb in collate_mixed_batch(
                    ds, idxs, plan, spk_counts[ds])]
            return lambda idxs: ranks.rows_of(collate(ds, idxs, plan), r)

    # RSH: each utterance's speaker count, from utt2num_spk or else the
    # sources in its npz file
    spk_counts = {ds: ds.num_spks if ds.num_spks is not None else
                  np.asarray([ds.load(i)["sources"].shape[0] for i in range(len(ds))])
                  for ds in (dataset, cv_dataset) if rsh and ds is not None}

    # the loader starts now, so epoch 1's first batches collate and copy
    # while the model is built, moved and checkpointed
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    copy_one = functools.partial(to_device, dev=dev, copy_stream=copy_stream, keys=keys)

    def copy(batch):
        if isinstance(batch, list):         # a mixed batch's sub-batches
            subs = [copy_one(sb) for sb in batch]
            return {"subs": subs, "n_real": sum(sb["n_real"] for sb in subs),
                    "names": [n for sb in subs for n in sb["names"]],
                    "h2d_bytes": sum(sb["h2d_bytes"] for sb in subs)}
        return copy_one(batch)

    epochs = iter_epochs(dataset, plan, range(loop_cfg.start_epoch, loop_cfg.num_epochs),
                         collate_fn=collate_for(dataset), transfer_fn=copy,
                         num_spks=spk_counts.get(dataset))

    model = arch.Model(model_cfg)
    model.reset_parameters(torch.Generator().manual_seed(loop_cfg.seed))
    model.to(dev)
    # draws the reference's N(0, 1) initial LSTM states, on the device
    generator = torch.Generator(device=dev).manual_seed(loop_cfg.seed)
    steps_per_epoch = max(1, -(-len(dataset) // loop_cfg.batch_size))

    epoch_losses: list[tuple[int, float]] = []
    cv_losses: list[tuple[int, float]] = []
    if loop_cfg.start_epoch == 0:
        fold_lstm_biases(model)
        optimizer = Optimizer(model.parameters(), loop_cfg, steps_per_epoch)
        if lead:
            save_checkpoint(intermediate_model_path(exp_dir, "init"), model,
                            optimizer=optimizer, generator=generator, epoch=0, meta=meta)
            # a fresh run starts the logs; a resumed one continues them
            open(loss_file, "w").close()
            if cv_dataset:
                open(cv_loss_file, "w").close()
    else:
        ckpt = load_checkpoint(intermediate_model_path(exp_dir, loop_cfg.start_epoch),
                               reference_resume=loop_cfg.reference_resume)
        model.load_state_dict(ckpt["model"])
        fold_lstm_biases(model)
        optimizer = Optimizer(model.parameters(), loop_cfg, steps_per_epoch)
        if ckpt["optimizer"] is not None:
            optimizer.load_state_dict(ckpt["optimizer"])
        if ckpt["generator"] is not None:
            generator.set_state(ckpt["generator"])
        if lead:
            epoch_losses = _truncate_loss_file(loss_file, loop_cfg.start_epoch)
            cv_losses = _truncate_loss_file(cv_loss_file, loop_cfg.start_epoch)

    plot_dir = os.path.join(stats_dir, "plots")
    plots = lead and loop_cfg.make_plots and _plots_available(log)
    beat = _heartbeat(loop_cfg.heartbeat_file if lead else "")
    profiler = _StepProfiler(loop_cfg.profile_dir if lead else "", loop_cfg.profile_steps,
                             dev, log)

    lossF = open(loss_file, "a") if lead else None
    cv_lossF = open(cv_loss_file, "a") if cv_dataset and lead else None
    steps: list[tuple[float, int]] = []
    h2d_bytes: list[int] = []
    epoch_times: list[tuple[int, float, float]] = []
    utts_seen = 0
    t_start = time.time()
    try:
        for epoch, batches in epochs:
            epoch_loss, epoch_norm, epoch_utts, n_steps = 0.0, 0.0, 0, 0
            t_epoch = time.time()
            for batch in batches:
                n_steps += 1
                profiler.before_step(len(steps))
                t0 = time.perf_counter()
                if "subs" in batch:
                    loss, norm = accumulate_step(
                        arch, model, optimizer,
                        [prepare(_wait_for_copy(sb)) for sb in batch["subs"]], generator)
                else:
                    loss, norm = update_step(arch, model, optimizer,
                                             prepare(_wait_for_copy(batch)), generator)
                loss, norm = float(loss), float(norm)
                steps.append(((time.perf_counter() - t0) * 1e3, batch["n_real"]))
                h2d_bytes.append(batch["h2d_bytes"])
                profiler.after_step(len(steps))
                beat()
                epoch_loss += loss * norm
                epoch_norm += norm
                epoch_utts += batch["n_real"]
            utts_seen += epoch_utts
            epoch_wall = time.time() - t_epoch
            step_s = sum(ms for ms, _ in steps[len(steps) - n_steps:]) / 1e3
            epoch_times.append((epoch + 1, epoch_wall, step_s))
            log(f"epoch {epoch + 1:03d} wall: {epoch_wall:.1f}s, steps {step_s:.1f}s "
                f"({epoch_utts / max(epoch_wall, 1e-9):.1f} utts/sec)")

            if cv_dataset and (epoch + 1) % CV_EVERY == 0:
                cv_loss_sum, cv_norm_sum = 0.0, 0.0
                first = plots
                for batch in iter_batches(cv_dataset, plan, 0, shuffle=False,
                                          collate_fn=collate_for(cv_dataset),
                                          transfer_fn=copy,
                                          num_spks=spk_counts.get(cv_dataset)):
                    for sb in batch.get("subs", [batch]):
                        sb = prepare(_wait_for_copy(sb))
                        loss, norm = eval_step(arch, model, sb, generator)
                        cv_loss_sum += float(loss) * float(norm)
                        cv_norm_sum += float(norm)
                        beat()
                        if first:
                            _plot_cv_batch(arch, model, sb, generator,
                                           os.path.join(plot_dir, f"epoch{epoch + 1:03d}"),
                                           log)
                            first = False
                cv_avg = cv_loss_sum / cv_norm_sum
                log(f"For epoch: {epoch + 1:03d} cv set loss is: {cv_avg}")
                if cv_lossF:
                    cv_lossF.write(f"{epoch + 1:03d} {cv_avg}\n")
                    cv_lossF.flush()
                cv_losses.append((epoch + 1, cv_avg))

            avg = epoch_loss / epoch_norm
            log(f"For epoch: {epoch + 1:03d} loss is: {avg}")
            if lossF:
                lossF.write(f"{epoch + 1:03d} {avg}\n")
                lossF.flush()
            epoch_losses.append((epoch + 1, avg))

            if lead and (epoch + 1) % CHECKPOINT_EVERY == 0:
                log(f"Saving model for epoch {epoch + 1:03d}")
                save_checkpoint(intermediate_model_path(exp_dir, epoch + 1), model,
                                optimizer=optimizer, generator=generator,
                                epoch=epoch + 1, meta=meta)
                beat()
                if plots:
                    _plot_losses(epoch_losses, cv_losses, os.path.join(
                        plot_dir, f"epoch{epoch + 1:03d}",
                        f"Loss_{epoch_losses[0][0]:03d}-{epoch + 1:03d}.png"), log)
            sys.stdout.flush()
    finally:
        profiler.stop()
        if lossF:
            lossF.close()
        if cv_lossF:
            cv_lossF.close()

    if lead:
        save_checkpoint(final_model_path(exp_dir), model, optimizer=optimizer,
                        generator=generator, epoch=loop_cfg.num_epochs, meta=meta)
    beat()
    if plots and epoch_losses:
        _plot_losses(epoch_losses, cv_losses, os.path.join(
            plot_dir, f"Loss_{epoch_losses[0][0]:03d}-{loop_cfg.num_epochs:03d}.png"), log)
    wall = time.time() - t_start
    log(f"trained {utts_seen} utterance-steps in {wall:.1f}s "
        f"({utts_seen / max(wall, 1e-9):.2f} utts/sec)")
    return {"model": model, "model_cfg": model_cfg, "epoch_losses": epoch_losses,
            "cv_losses": cv_losses, "steps": steps, "h2d_bytes": h2d_bytes,
            "epoch_times": epoch_times, "utts_per_sec": utts_seen / max(wall, 1e-9),
            "collation": getattr(dataset, "collation", "wav")}


def _heartbeat(path: str):
    """A function that touches ``path`` (nothing without one)."""
    if not path:
        return lambda: None
    open(path, "a").close()

    def beat():
        try:
            os.utime(path, None)
        except OSError:
            pass
    return beat


class _StepProfiler:
    """torch.profiler over the steps after the first (which builds the
    kernels and waits for the first batch), ``steps`` of them, as the JAX
    package skips its compile batch. On stop it writes ``trace.json`` (a
    Chrome trace, with the step's spans that utils/spans.py recorded meanwhile
    added as ``user_annotation`` events on their threads) and ``kernels.txt``
    (device time by kernel) into ``out_dir``. Without ``out_dir`` it does
    nothing."""

    def __init__(self, out_dir: str, steps: int, dev: torch.device, log):
        self.out_dir, self.steps, self.dev, self.log = out_dir, steps, dev, log
        self.prof = None
        self.done = not out_dir

    def before_step(self, n_done: int) -> None:
        if self.done or self.prof is not None or n_done < 1:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        spans.clear()
        self.prof.__enter__()

    def after_step(self, n_done: int) -> None:
        if self.prof is not None and n_done >= 1 + self.steps:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        prof, self.prof, self.done = self.prof, None, True
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"] += spans.chrome_events(spans.recorded(),
                                                  doc.get("baseTimeNanoseconds", 0), os.getpid())
        with open(path, "w") as f:
            json.dump(doc, f)
        sort = "self_cuda_time_total" if self.dev.type == "cuda" else "self_cpu_time_total"
        with open(os.path.join(self.out_dir, "kernels.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=60) + "\n")
        self.log(f"profiler trace written to {self.out_dir}")


def _plots_available(log) -> bool:
    from ..utils import plot
    if plot.available():
        return True
    log("plots skipped: matplotlib is not installed")
    return False


def _plot_losses(epoch_losses, cv_losses, path: str, log) -> None:
    from ..utils.plot import plot_loss
    try:
        plot_loss(list(zip(*epoch_losses)), list(zip(*cv_losses)) if cv_losses else None,
                  path)
    except Exception as e:  # a plot must never end a training run
        log(f"warning: loss plot failed: {e!r}")


def _plot_cv_batch(arch, model, batch: dict, generator: torch.Generator, plot_dir: str,
                   log) -> None:
    """The reference's CV plots of the first CV utterance (uPIT.py:199-204,
    RSH.py:243-252): for the uPIT contract (uPIT, TCN) the mixture, the
    masked mixture and the chosen permutation of the sources; for RSH the
    mixture and, each pass, its input, attention mask, mask, masked mixture
    and chosen source. Other archs (waveform batches) draw none. The loss
    runs again on a copy of the generator, so training's draws are kept."""
    if "mix" not in batch or arch.NAME not in ("uPIT", "TCN", "RSH"):
        return
    from ..ops.pit import make_permutations
    from ..utils.plot import plot_spec
    try:
        g = torch.Generator(device=generator.device)
        g.set_state(generator.get_state())
        # rank 0 alone plots: no collective may run here
        with torch.no_grad(), ranks.alone():
            _, aux = arch.loss_fn(model, batch, g, False)
        mix = batch["mix"][0].float().cpu().numpy()
        sources = batch["sources"][0].float().cpu().numpy()          # (S, T, F)
        if arch.NAME != "RSH":
            plot_spec(mix, os.path.join(plot_dir, "Mixture.png"))
            masked = aux["masked"][0].float().cpu().numpy()          # (T, S, F)
            T, S, F = masked.shape
            plot_spec(masked.reshape(T, S * F), os.path.join(plot_dir, "Masked_Mixture.png"))
            perm = make_permutations(S)[int(aux["best_perm"][0])]
            plot_spec(np.concatenate([sources[i] for i in perm], axis=1),
                      os.path.join(plot_dir, "Chosen_Permutation.png"))
            return
        masks = aux["masks"][0].float().cpu().numpy()                # (S, T, F)
        assigns = aux["assignments"][0].cpu().numpy()
        n = sources.shape[0]
        plot_spec(mix, os.path.join(plot_dir, f"{n}-Spk_Mix.png"))
        atten = np.ones_like(mix)
        for p in range(masks.shape[0]):
            prefix = os.path.join(plot_dir, f"{n}-Spk_Pass-{p + 1}_")
            plot_spec(np.concatenate([mix, atten], axis=1), prefix + "Input.png")
            plot_spec(atten, prefix + "Attenmask.png")
            plot_spec(masks[p], prefix + "Mask_Out.png")
            plot_spec(masks[p] * mix, prefix + "Masked_Mix.png")
            plot_spec(sources[assigns[p]], prefix + "Chosen_Source.png")
            atten = np.maximum(atten - masks[p], 0.0)
    except Exception as e:  # a plot must never end a training run
        log(f"warning: cv plotting failed: {e!r}")
