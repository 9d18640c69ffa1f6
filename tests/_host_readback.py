"""The card's readback path (io/queue.py's lent pinned buffers) driven
with ordinary CPU tensors: ``HostReadback`` takes a buffer from its lender
as ``DeviceReadback`` does for a CUDA tensor, and downloads by a plain
copy that is done at once. Install it with ``monkeypatch.setattr(queue,
"DeviceReadback", HostReadback)`` to run ``stream`` through it."""

import torch

from retrocapture_tpu_torch.io import queue


class _Done:
    """An event that has already happened."""

    def synchronize(self):
        pass


class HostReadback(queue.DeviceReadback):
    def __init__(self):
        super().__init__()
        self._lender = queue._Lender(torch.empty)
        HostReadback.last = self

    def _start(self, t):
        slot = self._lender.take(t.shape, t.dtype)
        slot.buf.copy_(t)
        return slot, _Done()
