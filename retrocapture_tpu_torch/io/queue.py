"""Host-side frame pipeline: bounded queue + double-buffered device feed
and async device→host readback. The port of
``retrocapture_tpu/io/queue.py``.

Equivalents of three reference components:

* the capture thread's bounded frame queue with drop-oldest overflow
  (VideoCaptureRemote.h:182-188, ~20 frames);
* FrameProcessor's CPU→GPU upload (processing/FrameProcessor.cpp:43) —
  ``DeviceFeeder`` stacks a batch into one of ``UPLOADS`` pinned host
  buffers and starts the upload on a side stream, so the DMA overlaps the
  compute of the batch before;
* PBOManager's double-buffered async readback (renderer/PBOManager.cpp:
  86-170) — ``DeviceReadback`` starts the download of the current batch
  into a pinned buffer of its own and returns the *previous* batch, one
  batch of latency by design.

The readback hands a batch out as a NumPy view of its pinned buffer, with
no copy. An array handed out is the caller's own: no later download
writes into a buffer while any array or frame view of its batch is alive,
and a buffer comes back for a later download once the caller has dropped
all of them. At most ``HELD`` pinned buffers serve the readback; where
lending one more would leave none for the next download, the batch is
copied out instead and its buffer freed at once.

On the card ``stream`` takes the source's frames on a thread of its own
and stacks them on another, ahead of the caller's: the thread that
launches the engine and waits for the downloads runs no producer and
copies no frame in. A profiler records the ranges of the thread that
started it, so the stacking thread's ``rctpu.queue.stack`` ranges show
only in a trace of all threads.

On a CPU device both are plain tensor conversions, and ``stream`` stacks
on the caller's thread.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from retrocapture_tpu_torch.policy import to_device
from retrocapture_tpu_torch.utils.trace import span

__all__ = ["FrameQueue", "DeviceFeeder", "DeviceReadback", "stream"]

# Pinned readback buffers at most: one downloading, one being handed out,
# the batch the caller still holds, one spare.
HELD = 4
# Pinned upload buffers: one uploading, and on the card up to two more
# batches stacked ahead of the caller by ``stream``'s stacking thread.
UPLOADS = 3


class FrameQueue:
    """Thread-safe bounded FIFO of frames with drop-oldest overflow."""

    def __init__(self, maxlen: int = 20):
        self._dq: collections.deque = collections.deque()
        self.maxlen = int(maxlen)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self.dropped = 0
        self.pushed = 0
        self._closed = False

    def push(self, frame: np.ndarray) -> None:
        with self._lock:
            if len(self._dq) >= self.maxlen:
                self._dq.popleft()
                self.dropped += 1
            self._dq.append(frame)
            self.pushed += 1
            self._not_empty.notify()

    def pop(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        with self._not_empty:
            if not self._dq and not self._closed:
                self._not_empty.wait(timeout)
            if not self._dq:
                return None
            return self._dq.popleft()

    def pop_batch(self, n: int, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        """Block until n frames are available (or closed); returns [n,...]."""
        out = []
        while len(out) < n:
            f = self.pop(timeout)
            if f is None:
                if self._closed or timeout is not None:
                    break
                continue
            out.append(f)
        if len(out) < n:
            return None
        return np.stack(out)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _pinned(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class _Upload:
    """One pinned upload buffer and the event of the last upload out of it."""

    __slots__ = ("buf", "copied")

    def __init__(self):
        self.buf = None
        self.copied = None


class _Slot:
    """One readback buffer and whether a download may write into it."""

    __slots__ = ("buf", "free")

    def __init__(self, buf: torch.Tensor):
        self.buf = buf
        self.free = False


class _Lease:
    """The owner of a lent batch's memory. The array handed out is made
    from this object's ``__array_interface__``, so the array and every
    view of it keep the lease alive; the last of them to go frees the
    buffer for a later download."""

    __slots__ = ("__array_interface__", "_slot")

    def __init__(self, slot: _Slot):
        self._slot = slot
        self.__array_interface__ = slot.buf.numpy().__array_interface__

    def __del__(self):
        self._slot.free = True


class _Lender:
    """The readback's pinned buffers, at most ``HELD``: ``take`` one for a
    download, ``hand_out`` its batch once the download is done."""

    def __init__(self, alloc: Callable = _pinned):
        self._alloc = alloc
        self._slots: list[_Slot] = []

    def take(self, shape, dtype) -> _Slot:
        """A buffer no array holds (made again where the batch's shape or
        dtype changed), else a new one."""
        for slot in self._slots:
            if slot.free:
                slot.free = False
                if slot.buf.shape != shape or slot.buf.dtype != dtype:
                    slot.buf = self._alloc(shape, dtype=dtype)
                return slot
        if len(self._slots) >= HELD:
            raise RuntimeError(f"all {HELD} readback buffers are in use")
        slot = _Slot(self._alloc(shape, dtype=dtype))
        self._slots.append(slot)
        return slot

    def hand_out(self, slot: _Slot) -> np.ndarray:
        """The batch in ``slot`` as the caller's own array: a view of the
        buffer while, with it lent, one buffer is left for the next
        download; else a copy, and the buffer is free at once."""
        if sum(not s.free for s in self._slots) < HELD:
            with span("rctpu.queue.handout"):
                return np.asarray(_Lease(slot))
        with span("rctpu.queue.copy_held"):
            out = slot.buf.numpy().copy()
            slot.free = True
            return out


class DeviceFeeder:
    """Buffered host→device transfer: ``put`` returns the device
    tensor for the *current* batch while the previous one is likely still
    processing. On the card the batch goes through one of ``UPLOADS``
    pinned buffers, used in turn, and a ``non_blocking`` copy on a side
    stream; the compute stream waits on the copy's event, the host does
    not. ``put`` is ``stage`` and ``send`` in one call: ``stage`` (the
    host's half: the frames stacked into a free pinned buffer) may run on
    another thread than ``send`` (the upload's enqueue), for up to
    ``UPLOADS`` staged batches that are not yet sent."""

    def __init__(self, device="cuda"):
        self.device = _device(device)
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._free = collections.deque(_Upload() for _ in range(UPLOADS))

    def put(self, batch: np.ndarray) -> torch.Tensor:
        with span("rctpu.queue.upload"):
            if self.device.type != "cuda":
                return to_device(batch, self.device)
            host = to_device(batch, "cpu")
            slot = self._take(host.shape, host.dtype)
            slot.buf.copy_(host)
            return self._send(slot)

    def stage(self, frames: list):
        """``frames`` stacked into one batch: on the card straight into a
        free pinned buffer, canonicalised as ``policy.to_device`` does."""
        with span("rctpu.queue.stack"):
            if self.device.type != "cuda":
                return np.stack(frames)
            first = np.asarray(frames[0])
            dtype = to_device(first[:0], "cpu").dtype
            slot = self._take((len(frames),) + first.shape, dtype)
            np.stack(frames, out=slot.buf.numpy())
            return slot

    def send(self, staged) -> torch.Tensor:
        """The upload of a batch ``stage`` returned."""
        with span("rctpu.queue.upload"):
            if self.device.type != "cuda":
                return to_device(staged, self.device)
            return self._send(staged)

    def _take(self, shape, dtype) -> _Upload:
        slot = self._free.popleft()
        if slot.copied is not None:
            with span("rctpu.queue.upload_wait"):
                slot.copied.synchronize()  # the upload that last read this buffer is done
        if slot.buf is None or slot.buf.shape != shape or slot.buf.dtype != dtype:
            slot.buf = _pinned(shape, dtype)
        return slot

    def _send(self, slot: _Upload) -> torch.Tensor:
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            dev = slot.buf.to(self.device, non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._stream)
        compute.wait_event(slot.copied)
        dev.record_stream(compute)
        self._free.append(slot)
        return dev


class DeviceReadback:
    """PBOManager-shaped async device→host readback: submit the current
    output, receive the previous one as NumPy. Needs >=2 submissions
    before data flows (PBOManager.cpp:137). On the card a submission
    starts a copy into a pinned buffer on a side stream, behind an event
    on the stream that computes the output; one submission later the
    event is waited for and the batch handed out as a view of that
    buffer. The caller owns the array: the buffer is not written again
    until the caller has dropped it and every frame of it. At most
    ``HELD`` buffers are pinned; where the caller holds so many batches
    that lending one more would leave no buffer for the next download,
    that batch is copied out instead."""

    def __init__(self):
        self._prev = None  # (buffer slot or host tensor, event or None)
        self._lender = _Lender()
        self._side = None  # the download stream, made at the first CUDA tensor

    def _start(self, t: torch.Tensor):
        if not t.is_cuda:
            return t, None
        if self._side is None:
            self._side = torch.cuda.Stream(t.device)
        side = self._side
        slot = self._lender.take(t.shape, t.dtype)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(side):
            side.wait_event(ready)
            slot.buf.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        t.record_stream(side)
        return slot, done

    def _finish(self, prev) -> np.ndarray:
        held, done = prev
        if done is None:
            with span("rctpu.queue.copy_out"):
                return held.numpy()
        with span("rctpu.queue.readback_wait"):
            done.synchronize()
        with span("rctpu.queue.copy_out"):
            return self._lender.hand_out(held)

    def submit(self, device_array: torch.Tensor) -> Optional[np.ndarray]:
        with span("rctpu.queue.readback"):
            prev, self._prev = self._prev, self._start(device_array)
            return None if prev is None else self._finish(prev)

    def flush(self) -> Optional[np.ndarray]:
        with span("rctpu.queue.readback"):
            prev, self._prev = self._prev, None
            return None if prev is None else self._finish(prev)


def _chunks(frames: Iterator[np.ndarray], batch: int) -> Iterator[list]:
    """The frames in lists of ``batch``, the last one shorter."""
    buf: list[np.ndarray] = []
    for f in frames:
        buf.append(f)
        if len(buf) == batch:
            yield buf
            buf = []
    if buf:
        yield buf


class _Ahead:
    """The source's batches staged ahead of the caller, at most
    ``UPLOADS`` of them, on two threads of their own: one takes the next
    batches' frames from the source, the other stacks each batch into one
    of the feeder's pinned buffers, while the caller's thread launches a
    batch and waits for the download of the one before. The two overlap,
    so the slower of them alone sets their pace. A batch's buffer is
    staged again only after the caller has sent it; ``close`` stops both
    threads at their next batch."""

    _END = object()

    def __init__(self, frames: Iterator[np.ndarray], batch: int, feeder: DeviceFeeder):
        self._ready: _queue.SimpleQueue = _queue.SimpleQueue()
        self._room = threading.Semaphore(UPLOADS)
        self._stop = False
        self._stager = ThreadPoolExecutor(1, thread_name_prefix="rctpu-queue-stage")
        self._thread = threading.Thread(
            target=self._run, args=(frames, batch, feeder), name="rctpu-queue-read", daemon=True)
        self._thread.start()

    def _run(self, frames, batch, feeder) -> None:
        try:
            for chunk in _chunks(frames, batch):
                self._room.acquire()
                if self._stop:
                    return
                self._ready.put(self._stager.submit(feeder.stage, chunk))
            self._ready.put(self._END)
        except BaseException as exc:  # handed to the caller's thread
            self._ready.put(exc)

    def __iter__(self):
        while True:
            item = self._ready.get()
            if item is self._END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item.result()
            # The batch yielded has been sent: its buffer may be staged again.
            self._room.release()

    def close(self) -> None:
        self._stop = True
        self._room.release()
        self._stager.shutdown(wait=False, cancel_futures=True)


def stream(
    source_frames: Iterator[np.ndarray],
    process: Callable[[torch.Tensor], torch.Tensor],
    *,
    batch: int = 8,
    device="cuda",
) -> Iterator[np.ndarray]:
    """Drive a frame iterator through ``process`` in batches with one
    batch of pipeline latency (feeder + readback composed). ``process``
    takes and returns a tensor on ``device``. Each frame yielded is the
    caller's own, a view of its batch's readback buffer on the card. On
    the card the source is read, and its batches stacked, on two threads
    of their own, up to ``UPLOADS`` batches ahead of ``process``."""
    feeder = DeviceFeeder(device)
    readback = DeviceReadback()
    if feeder.device.type == "cuda":
        ahead = _Ahead(iter(source_frames), batch, feeder)
        staged = iter(ahead)
    else:
        ahead = None
        staged = (feeder.stage(chunk) for chunk in _chunks(source_frames, batch))
    try:
        for batch_in in staged:
            out = readback.submit(process(feeder.send(batch_in)))
            if out is not None:
                yield from out
            # Hold no frame of the batch through the next submission: its
            # buffer comes back once the caller drops what it kept.
            out = None
        tail = readback.flush()
        if tail is not None:
            yield from tail
    finally:
        if ahead is not None:
            ahead.close()
