"""Live separation: push audio in, pull separated audio out.

The counterpart of speech_separation_tpu/eval/streaming.py, for either
causal architecture:

- the causal TCN (models/tcn.py, ``causal=True``), spectral masking: frames
  -> windowed rDFT product -> magnitude -> ``streaming_forward`` -> masks ->
  irDFT product; the host overlap-adds with per-sample window-sum
  normalization and emits a sample once no later frame can touch it. The
  center padding needs n_fft/2 samples of lookahead (32 ms at 8 kHz, n_fft
  512), besides the chunk;
- causal Conv-TasNet (models/convtasnet.py, ``causal=True``), time-domain
  masking: raw filter_len-sample frames -> encoder product ->
  ``streaming_forward`` -> masked latents -> decoder product; plain
  overlap-add, so the lookahead is one encoder window (4 ms at the defaults).

Each block's depthwise-conv context is carried as state, so chunk boundaries
are invisible: the concatenated output of a stream equals the offline
pipeline (eval/pipeline.SeparationPipeline) on the same audio. The state
lives on the device from chunk to chunk; per chunk only the frames go to it
and the separated frames come back. The products run in full f32 (TF32 off,
as in the pipeline).

Two surfaces, both on ``device`` (CUDA by default; they raise without a
card):

- :class:`StreamingSeparator`: one stream. ``push(samples)`` returns the
  newly final samples of each source, ``close()`` the tail.
- :class:`StreamingPool`: up to ``capacity`` concurrent streams batched into
  one chunk program. A slot's state is zeroed when it opens and frozen while
  it has no full chunk (the advance mask), so each stream's output is the
  one it would have alone.

Usage::

    sep = StreamingSeparator("causal_tcn.mdl", chunk_frames=16)
    for block in microphone():          # any block sizes
        tracks = sep.push(block)        # S arrays (possibly empty)
    tracks = sep.close()                # the tail
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.stft import _device_matrix, hann_periodic, istft_output_length, num_frames
from ..ops.mxu import rounded_dot
from ..utils.device import disable_tf32
from .infer import load_model


def _frozen_where_idle(new_state: list, old_state: list, advance: torch.Tensor) -> list:
    """Each row's new conv state where ``advance`` (B,) is true, its old one
    elsewhere: an idle slot's frames are dead compute."""
    adv = advance[:, None, None]
    return [torch.where(adv, n, o) for n, o in zip(new_state, old_state)]


@torch.inference_mode()
def _chunk_program(model, conv_state: list, frames: torch.Tensor, advance: torch.Tensor,
                   num_spk: int):
    """(B, C, n_fft) raw sample frames -> ((B, S, C, n_fft) masked, windowed
    time-domain frames, new conv state), causal TCN."""
    B, C, n_fft = frames.shape
    n_bins = n_fft // 2 + 1
    spec = torch.matmul(frames, _device_matrix("rdft", n_fft, frames.device))
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    mag = torch.sqrt(re * re + im * im)
    masks, new_state = model.streaming_forward(mag, conv_state)
    new_state = _frozen_where_idle(new_state, conv_state, advance)
    masks = masks.reshape(B, C, num_spk, n_bins).permute(0, 2, 1, 3)
    spec_s = torch.cat([re[:, None] * masks, im[:, None] * masks], dim=-1)
    return torch.matmul(spec_s, _device_matrix("irdft", n_fft, frames.device)), new_state


@torch.inference_mode()
def _time_chunk_program(model, conv_state: list, frames: torch.Tensor,
                        advance: torch.Tensor, num_spk: int):
    """(B, C, filter_len) raw sample frames -> ((B, S, C, filter_len) masked
    and decoded frames, new conv state), causal Conv-TasNet: the offline
    ``separate`` frame for frame; the host overlap-adds."""
    md = model.cfg.torch_dtype
    w = torch.relu(rounded_dot(frames, model.enc, md))
    masks, new_state = model.streaming_forward(w, conv_state)
    new_state = _frozen_where_idle(new_state, conv_state, advance)
    masked = (w[:, :, None, :] * masks).permute(0, 2, 1, 3)           # (B, S, C, N)
    return rounded_dot(masked, model.dec, md), new_state


class _StreamIO:
    """Host bookkeeping of ONE spectral stream: samples buffered in padded
    coordinates (reflect(half) + samples [+ reflect at close]), chunk
    extraction, overlap-add with per-sample window-sum normalization, and
    the emission of final samples. Holds no model state."""

    def __init__(self, num_spk: int, chunk_frames: int, n_fft: int, hop: int):
        self.S, self.C, self.n_fft, self.hop = num_spk, chunk_frames, n_fft, hop
        self.half = n_fft // 2
        self._w2 = np.asarray(hann_periodic(n_fft)) ** 2
        self._idx = np.arange(self.C)[:, None] * hop + np.arange(n_fft)[None, :]
        self._raw = []          # samples before half+1 of them are known
        self._buf = None        # float32, the padded stream's suffix
        self._buf_start = 0
        self._n_raw = 0         # samples received
        self._t_done = 0        # frames processed
        self._ola = np.zeros((num_spk, 0), np.float32)
        self._wss = np.zeros((0,), np.float32)
        self._ola_start = 0
        self._emitted = 0       # samples emitted, in signal coordinates
        self.closed = False

    def feed(self, samples) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._n_raw += len(samples)
        if self._buf is None:
            self._raw.append(samples)
            self._ensure_buf()
        else:
            self._buf = np.concatenate([self._buf, samples])

    def _ensure_buf(self) -> bool:
        if self._buf is not None:
            return True
        raw = np.concatenate(self._raw) if self._raw else np.zeros(0, np.float32)
        if len(raw) < self.half + 1:
            return False
        self._buf = np.concatenate([raw[1: self.half + 1][::-1], raw])
        self._raw = None
        return True

    def has_chunk(self) -> bool:
        """A full chunk of frames is buffered."""
        if self._buf is None:
            return False
        end_pad = (self._t_done + self.C - 1) * self.hop + self.n_fft
        return end_pad <= self._buf_start + len(self._buf)

    def take_chunk(self, tail: bool = False):
        """The next chunk's (C, n_fft) frames and its count of valid frames;
        ``tail`` allows a final partial chunk (zero frames past the stream's
        frame count)."""
        t0 = self._t_done
        n_valid = min(self.C, num_frames(self._n_raw, self.hop) - t0) if tail else self.C
        a = t0 * self.hop - self._buf_start
        need = (self.C - 1) * self.hop + self.n_fft
        seg = self._buf[a: a + need]
        if len(seg) < need:
            seg = np.pad(seg, (0, need - len(seg)))
        return seg[self._idx], n_valid

    def accept(self, y: np.ndarray, n_valid: int) -> None:
        """Overlap-add ``n_valid`` frames of (S, C, n_fft) program output."""
        y = y[:, :n_valid, :]
        t0 = self._t_done
        upto = (t0 + n_valid - 1) * self.hop + self.n_fft
        need = upto - self._ola_start - self._wss.shape[0]
        if need > 0:
            self._ola = np.pad(self._ola, [(0, 0), (0, need)])
            self._wss = np.pad(self._wss, (0, need))
        for j in range(n_valid):
            off = (t0 + j) * self.hop - self._ola_start
            self._ola[:, off: off + self.n_fft] += y[:, j, :]
            self._wss[off: off + self.n_fft] += self._w2
        self._t_done += n_valid
        # consumed samples: later frames start at t_done*hop
        cut = self._t_done * self.hop - self._buf_start
        if 0 < cut <= len(self._buf):
            self._buf = self._buf[cut:]
            self._buf_start += cut

    def emit_live(self) -> list:
        return self._emit(max(0, self._t_done * self.hop - self.half))

    def _emit(self, upto_signal: int) -> list:
        n = upto_signal - self._emitted
        if n <= 0:
            return [np.zeros(0, np.float32) for _ in range(self.S)]
        a = self._emitted + self.half - self._ola_start
        num = self._ola[:, a: a + n]
        den = self._wss[a: a + n]
        tiny = np.finfo(np.float32).tiny
        out = np.where(den > tiny, num / den, num).astype(np.float32)
        keep_from = max(0, min(self._t_done * self.hop - self._ola_start, a + n))
        self._ola = self._ola[:, keep_from:]
        self._wss = self._wss[keep_from:]
        self._ola_start += keep_from
        self._emitted = upto_signal
        return [out[s] for s in range(self.S)]

    def start_close(self) -> int:
        """Append the end reflect padding; returns the total frame count.
        Then take_chunk(tail=True)/accept until t_done reaches it, then
        finish_close()."""
        if not self._ensure_buf():
            raise ValueError(f"stream too short ({self._n_raw} samples; "
                             f"need more than n_fft/2 = {self.half})")
        total = self._n_raw
        # the right side of reflect_pad_center; raw[k] lives at padded k + half
        idx = [total - 2 - i + self.half - self._buf_start for i in range(self.half)]
        self._buf = np.concatenate([self._buf, self._buf[idx].astype(np.float32)])
        return num_frames(total, self.hop)

    def finish_close(self) -> list:
        return self._emit(istft_output_length(num_frames(self._n_raw, self.hop), self.hop))


class _TimeStreamIO:
    """Host bookkeeping of ONE time-domain (Conv-TasNet) stream, with
    :class:`_StreamIO`'s interface: frames are raw ``filter_len``-sample
    windows at ``stride`` with no center padding, and the decoder's frames
    overlap-add with no window normalization. Sample s is final once every
    frame touching it is in (t_done*stride > s). The frame count and the
    tail's zero padding are waveform.valid_latent_frames', so the output
    equals the offline ``separate`` cut to the stream's length."""

    def __init__(self, num_spk: int, chunk_frames: int, filter_len: int, stride: int):
        self.S, self.C = num_spk, chunk_frames
        self.fl, self.st = filter_len, stride
        self._idx = np.arange(self.C)[:, None] * stride + np.arange(filter_len)[None, :]
        self._buf = np.zeros((0,), np.float32)
        self._buf_start = 0      # stream coordinate of _buf[0]
        self._n_raw = 0          # samples received
        self._t_done = 0         # frames processed
        self._ola = np.zeros((num_spk, 0), np.float32)
        self._ola_start = 0
        self._emitted = 0
        self.closed = False

    def feed(self, samples) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._n_raw += len(samples)
        self._buf = np.concatenate([self._buf, samples])

    def _total_frames(self) -> int:
        """The offline frame count ceil(n / stride), at least 1."""
        return max(1, -(-self._n_raw // self.st))

    def has_chunk(self) -> bool:
        need = (self._t_done + self.C - 1) * self.st + self.fl
        return need <= self._buf_start + len(self._buf)

    def take_chunk(self, tail: bool = False):
        t0 = self._t_done
        n_valid = min(self.C, self._total_frames() - t0) if tail else self.C
        a = t0 * self.st - self._buf_start
        need = (self.C - 1) * self.st + self.fl
        seg = self._buf[a: a + need]
        if len(seg) < need:  # tail frames read zeros past the stream's end
            seg = np.pad(seg, (0, need - len(seg)))
        return seg[self._idx], n_valid

    def accept(self, y: np.ndarray, n_valid: int) -> None:
        """Overlap-add ``n_valid`` frames of (S, C, filter_len) program output."""
        y = y[:, :n_valid, :]
        t0 = self._t_done
        upto = (t0 + n_valid - 1) * self.st + self.fl
        need = upto - self._ola_start - self._ola.shape[1]
        if need > 0:
            self._ola = np.pad(self._ola, [(0, 0), (0, need)])
        for j in range(n_valid):
            off = (t0 + j) * self.st - self._ola_start
            self._ola[:, off: off + self.fl] += y[:, j, :]
        self._t_done += n_valid
        cut = max(0, min(self._t_done * self.st - self._buf_start, len(self._buf)))
        if cut:
            self._buf = self._buf[cut:]
            self._buf_start += cut

    def emit_live(self) -> list:
        return self._emit(min(self._t_done * self.st, self._n_raw))

    def _emit(self, upto: int) -> list:
        n = upto - self._emitted
        if n <= 0:
            return [np.zeros(0, np.float32) for _ in range(self.S)]
        a = self._emitted - self._ola_start
        out = self._ola[:, a: a + n].astype(np.float32)
        keep_from = max(0, min(self._t_done * self.st - self._ola_start, a + n))
        self._ola = self._ola[:, keep_from:]
        self._ola_start += keep_from
        self._emitted = upto
        return [out[s] for s in range(self.S)]

    def start_close(self) -> int:
        if self._n_raw < 1:
            raise ValueError("stream too short (0 samples)")
        return self._total_frames()

    def finish_close(self) -> list:
        return self._emit(self._n_raw)


class _Model:
    """A loaded causal model for the streaming surfaces: the causal TCN
    (spectral) or causal Conv-TasNet (time domain), with its chunk program,
    its kind of stream bookkeeping and its zeroed conv state."""

    def __init__(self, model_path, model_kwargs, n_fft, hop, device):
        self.arch, self.cfg, self.model = load_model(model_path, "", model_kwargs, device)
        self.device = next(self.model.parameters()).device
        causal = getattr(self.cfg, "causal", False)
        if self.arch.NAME not in ("TCN", "ConvTasNet") or not causal:
            raise ValueError(
                "streaming needs a causal model — TCN (models/tcn.py) or "
                "ConvTasNet (models/convtasnet.py) with causal=true; got "
                f"arch={self.arch.NAME} causal={causal}")
        # every f32 product of the chunk in full f32, as the pipeline's
        disable_tf32()
        self.domain = self.arch.DOMAIN
        if self.domain == "time":
            self.program = _time_chunk_program
            self._io_args = (self.cfg.filter_len, self.cfg.stride)
            self.frame_width = self.cfg.filter_len
        else:
            if self.cfg.feat_dim != n_fft // 2 + 1:
                raise ValueError(f"model feat_dim {self.cfg.feat_dim} does not match "
                                 f"n_fft {n_fft}")
            self.program = _chunk_program
            self._io_args = (n_fft, hop)
            self.frame_width = n_fft

    def init_stream_state(self, batch: int) -> list:
        return self.arch.init_stream_state(self.cfg, batch, self.device)

    def make_io(self, chunk_frames: int):
        io_cls = _TimeStreamIO if self.domain == "time" else _StreamIO
        return io_cls(self.cfg.num_spk, chunk_frames, *self._io_args)

    def run(self, state: list, frames: np.ndarray, advance: np.ndarray):
        """One chunk on the device: frames (B, C, width) and advance (B,)
        from the host; returns ((B, S, C, width) frames on the host, the new
        state on the device)."""
        y, state = self.program(self.model, state,
                                torch.from_numpy(frames).to(self.device),
                                torch.from_numpy(advance).to(self.device), self.cfg.num_spk)
        return y.cpu().numpy(), state


class StreamingSeparator:
    """Live separation of one audio stream (one model, S tracks) on
    ``device`` (CUDA by default).

    ``push(samples)`` takes any number of float32 samples and returns the
    newly final separated samples (S arrays, possibly empty); ``close()``
    flushes the tail. Each output sample is emitted once, in order, and the
    concatenated output of a track equals the offline pipeline's track
    (spectral models: hop*(T-1) samples; time-domain models: the stream's
    sample count)."""

    def __init__(self, model_path: str, chunk_frames: int = 16,
                 model_kwargs: dict | None = None, n_fft: int = 512, hop: int = 128,
                 device=None):
        self._m = m = _Model(model_path, model_kwargs, n_fft, hop, device)
        self.cfg = m.cfg
        self.S = self.cfg.num_spk
        self._state = m.init_stream_state(1)
        self._io = m.make_io(chunk_frames)
        self._adv = np.ones((1,), bool)

    def _run(self, frames, n_valid):
        y, self._state = self._m.run(self._state, frames[None], self._adv)
        self._io.accept(y[0], n_valid)

    def push(self, samples) -> list:
        if self._io.closed:
            raise RuntimeError("push after close")
        self._io.feed(samples)
        while self._io.has_chunk():
            self._run(*self._io.take_chunk())
        return self._io.emit_live()

    def close(self) -> list:
        if self._io.closed:
            raise RuntimeError("close twice")
        self._io.closed = True
        t_total = self._io.start_close()
        while self._io._t_done < t_total:
            self._run(*self._io.take_chunk(tail=True))
        return self._io.finish_close()


class StreamingPool:
    """Up to ``capacity`` concurrent live streams batched into one chunk
    program on ``device`` (CUDA by default): the chunk's cost is shared by
    every active slot, and the per-row conv state keeps slots apart, so a
    stream's output is the one it would have alone.

    Slots join (``open``), take audio (``push``) and leave (``close``) on
    their own. ``step()`` runs one batched chunk over every slot with a full
    chunk buffered; starved and empty slots ride along as dead compute with
    their state frozen by the advance mask::

        pool = StreamingPool(model, capacity=8)
        a, b = pool.open(), pool.open()
        pool.push(a, block_a); pool.push(b, block_b)
        for slot, tracks in pool.step().items(): ...
        tracks = pool.close(a)       # slot a's tail; the slot is free again
    """

    def __init__(self, model_path: str, capacity: int = 8, chunk_frames: int = 16,
                 model_kwargs: dict | None = None, n_fft: int = 512, hop: int = 128,
                 device=None):
        self._m = m = _Model(model_path, model_kwargs, n_fft, hop, device)
        self.cfg = m.cfg
        self.S = self.cfg.num_spk
        self.B, self.C = capacity, chunk_frames
        self._state = m.init_stream_state(capacity)
        self._io: list = [None] * capacity

    def open(self) -> int:
        """Claim a free slot; its conv state starts at zeros (a fresh
        stream's left padding). Returns the slot id."""
        for slot in range(self.B):
            if self._io[slot] is None:
                self._io[slot] = self._m.make_io(self.C)
                with torch.inference_mode():      # the state is the program's output
                    for st in self._state:
                        st[slot] = 0.0
                return slot
        raise RuntimeError(f"pool full ({self.B} slots)")

    def push(self, slot: int, samples) -> None:
        io = self._io[slot]
        if io is None or io.closed:
            raise RuntimeError(f"slot {slot} is not open")
        io.feed(samples)

    def _run_batched(self, per_slot: dict) -> None:
        """per_slot: {slot: (frames, n_valid)}, one batched chunk."""
        frames = np.zeros((self.B, self.C, self._m.frame_width), np.float32)
        adv = np.zeros((self.B,), bool)
        for slot, (f, _nv) in per_slot.items():
            frames[slot] = f
            adv[slot] = True
        y, self._state = self._m.run(self._state, frames, adv)
        for slot, (_f, n_valid) in per_slot.items():
            self._io[slot].accept(y[slot], n_valid)

    def step(self) -> dict:
        """Advance every slot with a full buffered chunk by one chunk.
        Returns {slot: [S arrays of newly final samples]} for the slots that
        advanced ({} if none was ready)."""
        ready = {slot: io.take_chunk() for slot, io in enumerate(self._io)
                 if io is not None and not io.closed and io.has_chunk()}
        if not ready:
            return {}
        self._run_batched(ready)
        return {slot: self._io[slot].emit_live() for slot in ready}

    def close(self, slot: int) -> list:
        """Flush one stream's tail and free its slot. Returns every sample
        of the stream not yet emitted (its buffered full chunks are drained
        here too: only this slot advances, the others stay frozen)."""
        io = self._io[slot]
        if io is None or io.closed:
            raise RuntimeError(f"slot {slot} is not open")
        while io.has_chunk():
            self._run_batched({slot: io.take_chunk()})
        io.closed = True
        t_total = io.start_close()
        while io._t_done < t_total:
            self._run_batched({slot: io.take_chunk(tail=True)})
        out = io.finish_close()
        self._io[slot] = None
        return out
