"""Persistent separation server: a warm model behind a Unix-domain socket.

The counterpart of speech_separation_tpu/eval/serve.py. ``serve`` holds a
:class:`~.pipeline.SeparationPipeline` on the card and answers requests over
a local socket. The server always runs the pipeline with
``pad_batches=True``, so every batch has the full ``batch_size`` rows and
``--warmup-sec`` pre-pays the first batch of each length bucket.

Protocol: newline-delimited JSON over a ``SOCK_STREAM`` Unix socket.

Requests::

    {"wavs": ["/abs/in.wav", ...], "out_dir": "/abs/dir"}
        optional: "num_spk": int, "long_form": true,
                  "window_sec"/"overlap_sec": float (long-form only)
    {"cmd": "ping"}
    {"cmd": "shutdown"}

Responses (one JSON line per request, in request order per connection)::

    {"ok": true, "outputs": {"<wav path>": ["/abs/dir/<stem>_s1.wav", ...]},
     "ms": 12.3}                       # wall of the device batch it rode in
    {"ok": true, "uptime_s": ..., "served": N, "compiled_buckets": K}
    {"ok": false, "error": "..."}

Live streaming (when the server is started with a causal TCN or
Conv-TasNet streaming model, ``serve --streaming-model``): any JSON-capable
client can run real-time separation over the socket::

    {"cmd": "stream_open"}
        -> {"ok": true, "slot": k, "sample_rate": 8000, "num_spk": S}
    {"cmd": "stream_push", "slot": k, "pcm16": "<base64 int16 LE>"}
        -> {"ok": true, "tracks": ["<base64 pcm16>", ...]}   # newly final
    {"cmd": "stream_close", "slot": k}
        -> {"ok": true, "tracks": [...]}                     # the tail

Concurrent streams share one batched chunk program
(eval/streaming.StreamingPool), behind one lock; what a step emits for slot
A while serving slot B's push is kept and returned with A's next reply.
Without a streaming model those commands answer ``{"ok": false, ...}``.

``num_spk`` is the count of sources to extract: any count for an RSH model
(one pass each), a fixed-head model's own count otherwise. Requests of
different counts run as different batches.

Dynamic micro-batching: requests from concurrent connections are coalesced
into one device batch. A file that fails to load fails only its own request.
Output naming is ``<out_dir>/<input stem>_s<k>.wav``; inputs whose stems
collide within one request are rejected up front.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import socket
import threading
import time
from collections import deque

import numpy as np

from ..utils.audio import (limit_peak, load_wav, separated_track_paths,
                           wav_num_samples, write_wav_int16)


class _Pending:
    """One in-flight request: payload in, reply out via an event."""

    def __init__(self, payload: dict):
        self.payload = payload
        self.event = threading.Event()
        self.reply: dict = {}

    def finish(self, reply: dict) -> None:
        self.reply = reply
        self.event.set()


def _validate(payload: dict) -> str | None:
    """Schema-check a separation request (arbitrary JSON from the socket).
    Returns an error string or None."""
    wavs = payload.get("wavs")
    if (not isinstance(wavs, list) or not wavs
            or not all(isinstance(w, str) for w in wavs)):
        return "'wavs' must be a non-empty list of path strings"
    out_dir = payload.get("out_dir")
    if not isinstance(out_dir, str) or not out_dir:
        return "'out_dir' must be a non-empty path string"
    num_spk = payload.get("num_spk")
    if num_spk is not None and (not isinstance(num_spk, int)
                                or isinstance(num_spk, bool) or num_spk < 1):
        return "'num_spk' must be a positive integer"
    if not isinstance(payload.get("long_form", False), bool):
        return "'long_form' must be a boolean"
    for k in ("window_sec", "overlap_sec"):
        v = payload.get(k)
        if v is not None and (not isinstance(v, (int, float))
                              or isinstance(v, bool) or v <= 0):
            return f"'{k}' must be a positive number"
    stems = [os.path.splitext(os.path.basename(w))[0] for w in wavs]
    if len(set(stems)) != len(stems):
        return ("input basenames collide within the request; outputs are "
                "named <out_dir>/<stem>_s<k>.wav")
    return None


class SeparationServer:
    """Serve a warm :class:`SeparationPipeline` over a Unix socket.

    ``coalesce`` bounds how many queued requests one dispatch may merge; the
    pipeline's ``batch_size`` still sets the batch shape (a larger merged
    group streams as several batches).
    """

    def __init__(self, pipeline, socket_path: str, coalesce: int = 32, stream_pool=None):
        self.pipe = pipeline
        self.socket_path = socket_path
        self.coalesce = coalesce
        # live streaming (optional): a streaming.StreamingPool, one lock
        # around every call into it; emissions for other slots than the one
        # served are parked per slot
        self._pool = stream_pool
        self._pool_lock = threading.Lock()
        self._pool_pending: dict = {}   # slot -> [S lists of arrays]
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._started = time.monotonic()
        self._served = 0
        # end-to-end request latencies (queue wait + device + writes), last
        # 512, for ping's percentile report
        self._latencies: "deque[float]" = deque(maxlen=512)
        self._listener: socket.socket | None = None
        self._worker_thread: threading.Thread | None = None

    # ---------------------------------------------------------------- setup

    def warmup(self, seconds: list[float]) -> int:
        """Run one full batch per given audio length, so the first request
        of each length bucket finds the card warm. Returns the number of
        new buckets."""
        sr = self.pipe.stft_cfg.sample_rate
        before = len(self.pipe.buckets)
        for sec in seconds:
            n = max(int(sec * sr), self.pipe.stft_cfg.n_fft)
            sigs = [np.zeros(n, np.float32)] * self.pipe.batch_size
            for _ in self.pipe.separate_stream(
                    sigs.__getitem__, [n] * len(sigs), pad_batches=True):
                pass
        return len(self.pipe.buckets) - before

    # ------------------------------------------------------------- lifecycle

    def serve_forever(self) -> None:
        """Bind, accept, and block until a ``shutdown`` request arrives."""
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(64)
        # a blocked accept() is not reliably interrupted by close() from
        # another thread; poll with a short timeout so shutdown() takes effect
        self._listener.settimeout(0.25)
        self._worker_thread = threading.Thread(target=self._worker, daemon=True)
        self._worker_thread.start()
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break  # listener closed by shutdown
                threading.Thread(target=self._handle_conn, args=(conn,),
                                 daemon=True).start()
        finally:
            self._cleanup()

    def shutdown(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    def _drain_queue(self) -> None:
        """Fail any still-queued requests so their clients get a reply."""
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                return
            p.finish({"ok": False, "error": "server shutting down"})

    def _cleanup(self) -> None:
        self._stop.set()
        if self._worker_thread is not None:
            self._worker_thread.join(timeout=5)
        self._drain_queue()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    # ------------------------------------------------------------ connection

    def _handle_conn(self, conn: socket.socket) -> None:
        with conn, conn.makefile("rwb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    payload = json.loads(line)
                    reply = self._dispatch(payload)
                except Exception as e:  # a malformed request must not kill us
                    reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                try:
                    f.write(json.dumps(reply).encode() + b"\n")
                    f.flush()
                except OSError:
                    return  # client went away
                if self._stop.is_set():
                    return

    def _dispatch(self, payload: dict) -> dict:
        cmd = payload.get("cmd")
        if cmd == "ping":
            reply = {"ok": True,
                     "uptime_s": round(time.monotonic() - self._started, 3),
                     "served": self._served,
                     "compiled_buckets": len(self.pipe.buckets)}
            if self._latencies:
                lats = sorted(self._latencies)
                pick = lambda q: lats[min(len(lats) - 1,
                                          int(q * (len(lats) - 1) + 0.5))]
                reply["latency_ms"] = {
                    "n": len(lats),
                    "p50": round(pick(0.50) * 1e3, 2),
                    "p99": round(pick(0.99) * 1e3, 2),
                    "max": round(lats[-1] * 1e3, 2)}
            return reply
        if cmd == "shutdown":
            self.shutdown()
            return {"ok": True}
        if cmd in ("stream_open", "stream_push", "stream_close"):
            return self._dispatch_stream(cmd, payload)
        if cmd is not None:
            return {"ok": False, "error": f"unknown cmd {cmd!r}"}

        err = _validate(payload)
        if err:
            return {"ok": False, "error": err}
        # fail fast (and per-request) on unreadable inputs
        try:
            lengths = [wav_num_samples(p) for p in payload["wavs"]]
        except Exception as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        os.makedirs(payload["out_dir"], exist_ok=True)
        if self._stop.is_set():
            return {"ok": False, "error": "server shutting down"}
        pending = _Pending({**payload, "lengths": lengths})
        t0 = time.monotonic()
        self._queue.put(pending)
        if self._stop.is_set():
            # shutdown may have drained the queue between the check above
            # and our put: drain again so this request gets a reply
            self._drain_queue()
        pending.event.wait()
        if pending.reply.get("ok"):
            self._latencies.append(time.monotonic() - t0)
        return pending.reply

    # ------------------------------------------------------------- streaming

    @staticmethod
    def _b64_to_f32(b64: str) -> np.ndarray:
        pcm = np.frombuffer(base64.b64decode(b64, validate=True), dtype="<i2")
        return pcm.astype(np.float32) / 32768.0

    @staticmethod
    def _f32_to_b64(x: np.ndarray) -> str:
        pcm = np.clip(np.rint(np.asarray(x) * 32768.0), -32768, 32767).astype("<i2")
        return base64.b64encode(pcm.tobytes()).decode()

    def _park(self, results: dict, keep: int | None) -> None:
        """Keep step() emissions of every slot except ``keep``."""
        for slot, tracks in results.items():
            if slot == keep:
                continue
            bufs = self._pool_pending.setdefault(slot, [[] for _ in range(self._pool.S)])
            for s, t in enumerate(tracks):
                if len(t):
                    bufs[s].append(t)

    def _take_pending(self, slot: int, tracks=None) -> list:
        """The slot's parked samples then ``tracks``, as S pcm16 strings."""
        bufs = self._pool_pending.pop(slot, None)
        S = self._pool.S
        out = [[] for _ in range(S)]
        if bufs:
            for s in range(S):
                out[s].extend(bufs[s])
        if tracks:
            for s in range(S):
                if len(tracks[s]):
                    out[s].append(tracks[s])
        cat = [np.concatenate(o) if o else np.zeros(0, np.float32) for o in out]
        return [self._f32_to_b64(t) for t in cat]

    def _dispatch_stream(self, cmd: str, payload: dict) -> dict:
        if self._pool is None:
            return {"ok": False, "error": "server started without --streaming-model"}
        with self._pool_lock:
            if cmd == "stream_open":
                try:
                    slot = self._pool.open()
                except RuntimeError as e:
                    return {"ok": False, "error": str(e)}
                return {"ok": True, "slot": slot,
                        "sample_rate": self.pipe.stft_cfg.sample_rate,
                        "num_spk": self._pool.S}
            slot = payload.get("slot")
            if (not isinstance(slot, int) or isinstance(slot, bool)
                    or not 0 <= slot < self._pool.B or self._pool._io[slot] is None):
                return {"ok": False, "error": f"slot {slot!r} is not open"}
            if cmd == "stream_push":
                b64 = payload.get("pcm16")
                if not isinstance(b64, str):
                    return {"ok": False,
                            "error": "'pcm16' must be a base64 string of "
                                     "little-endian int16 samples"}
                try:
                    samples = self._b64_to_f32(b64)
                except ValueError as e:       # binascii.Error, odd byte count
                    return {"ok": False, "error": f"bad pcm16: {e}"}
                self._pool.push(slot, samples)
                results = self._pool.step()
                self._park(results, keep=slot)
                return {"ok": True, "tracks": self._take_pending(slot, results.get(slot))}
            # stream_close
            try:
                tracks = self._pool.close(slot)
            except ValueError as e:           # stream too short
                self._pool._io[slot] = None
                self._pool_pending.pop(slot, None)
                return {"ok": False, "error": str(e)}
            return {"ok": True, "tracks": self._take_pending(slot, tracks)}

    # ---------------------------------------------------------------- worker

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            group = [first]
            while len(group) < self.coalesce:
                try:
                    group.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            try:
                # requests with different speaker counts / modes run as
                # different batches
                buckets: dict[tuple, list[_Pending]] = {}
                for p in group:
                    key = (p.payload.get("num_spk"),
                           bool(p.payload.get("long_form")))
                    buckets.setdefault(key, []).append(p)
                for (num_spk, long_form), ps in buckets.items():
                    try:
                        if long_form:
                            self._run_long_form(ps, num_spk)
                        else:
                            self._run_batched(ps, num_spk)
                    except Exception as e:
                        self._fail(ps, e)
            except Exception as e:
                # nothing may kill the worker thread: a dead worker would
                # hang every future request on event.wait()
                self._fail(group, e)
        self._drain_queue()

    @staticmethod
    def _fail(ps: list[_Pending], e: Exception) -> None:
        for p in ps:
            if not p.event.is_set():
                p.finish({"ok": False, "error": f"{type(e).__name__}: {e}"})

    def _run_batched(self, ps: list[_Pending], num_spk: int | None) -> None:
        """Coalesce every wav of every request into one streaming pass."""
        sr = self.pipe.stft_cfg.sample_rate
        flat: list[tuple[_Pending, str]] = [
            (p, w) for p in ps for w in p.payload["wavs"]]
        lengths = [n for p in ps for n in p.payload["lengths"]]
        load_errors: dict[int, str] = {}

        def loader(i):
            # a file that vanished or broke since validation fails only its
            # own request: silence goes through the card instead
            try:
                return load_wav(flat[i][1], sr=sr)[0]
            except Exception as e:
                load_errors[i] = f"{type(e).__name__}: {e}"
                return np.zeros(1, np.float32)

        S = num_spk or self.pipe.num_spk
        remaining = {id(p): len(p.payload["wavs"]) for p in ps}
        outputs: dict[int, dict] = {id(p): {} for p in ps}
        failures: dict[int, list[str]] = {id(p): [] for p in ps}
        t0 = time.monotonic()
        for i, tracks in self.pipe.separate_stream(loader, lengths, num_spk,
                                                   pad_batches=True):
            p, wav = flat[i]
            if i in load_errors:
                failures[id(p)].append(f"{wav}: {load_errors[i]}")
            else:
                paths = separated_track_paths(p.payload["out_dir"], wav, S)
                for path, est in zip(paths, limit_peak(tracks)):
                    write_wav_int16(path, sr, est)
                outputs[id(p)][wav] = paths
            remaining[id(p)] -= 1
            if remaining[id(p)] == 0:
                ms = round((time.monotonic() - t0) * 1e3, 2)
                if failures[id(p)]:
                    p.finish({"ok": False,
                              "error": "; ".join(failures[id(p)]),
                              "outputs": outputs[id(p)], "ms": ms})
                else:
                    self._served += 1
                    p.finish({"ok": True, "outputs": outputs[id(p)], "ms": ms})

    def _run_long_form(self, ps: list[_Pending], num_spk: int | None) -> None:
        sr = self.pipe.stft_cfg.sample_rate
        S = num_spk or self.pipe.num_spk
        for p in ps:
            t0 = time.monotonic()
            outs = {}
            kw = {}
            if "window_sec" in p.payload:
                kw["window_sec"] = float(p.payload["window_sec"])
            if "overlap_sec" in p.payload:
                kw["overlap_sec"] = float(p.payload["overlap_sec"])
            try:
                for wav in p.payload["wavs"]:
                    x, _ = load_wav(wav, sr=sr)
                    tracks = self.pipe.separate_long(x, num_spk, **kw)
                    paths = separated_track_paths(p.payload["out_dir"], wav, S)
                    for path, est in zip(paths, limit_peak(tracks)):
                        write_wav_int16(path, sr, est)
                    outs[wav] = paths
            except Exception as e:
                p.finish({"ok": False, "error": f"{type(e).__name__}: {e}",
                          "outputs": outs})
                continue
            self._served += 1
            p.finish({"ok": True, "outputs": outs,
                      "ms": round((time.monotonic() - t0) * 1e3, 2)})


def request(socket_path: str, payload: dict, timeout: float = 600.0) -> dict:
    """Send one request to a running server and return its reply dict.

    Raises ``ConnectionError`` if the server closes the connection without
    a complete reply."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall(json.dumps(payload).encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    if not buf.endswith(b"\n"):
        raise ConnectionError(
            f"server at {socket_path} closed the connection without a "
            f"complete reply ({len(buf)} bytes received)")
    return json.loads(buf.decode())
