"""Double-buffered host -> device prefetch of whole epochs (counterpart of
vqvaehmm_tpu/data/prefetch.py).

The host-fed trainers consume stacked epochs; `prefetch_epochs` assembles
the next one (data/dataset.py::epoch_arrays) on a daemon thread while the
current epoch trains.  The thread draws the dataset's numpy stream in the
same order as the synchronous loop, so the losses are bit-equal with or
without it.  For a CUDA device the thread copies each epoch into pinned
host memory, then to the device on a side stream, and records an event;
the consumer's stream waits on that event before the epoch is handed out,
and each tensor is marked as used by the consumer's stream, so the
allocator does not hand its memory back to the side stream while the
consumer's work may still read it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import torch

from .dataset import RandomChunkDataset, epoch_arrays


def prefetch_epochs(dataset: RandomChunkDataset, batch_size: int,
                    num_epochs: int, num_batches: Optional[int] = None,
                    buffer_size: int = 2, device="cuda"
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]]:
    """Yields (xs, us, lengths) tensors on `device` for each epoch,
    produced ahead of consumption on a daemon thread.  A producer's
    exception is raised in the consumer; closing the generator early
    stops the producer."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # CUDA's current device is per thread: pin it for the producer
        dev = torch.device("cuda", torch.cuda.current_device())
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()

    def put_unless_stopped(item) -> bool:
        # a plain q.put would block forever on a full queue after the
        # consumer stopped early, leaking this thread and its tensors
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def upload(arrays):
        tensors = [torch.from_numpy(a) for a in arrays]
        if dev.type != "cuda":
            return tuple(t.to(dev) for t in tensors), None
        with torch.cuda.stream(side):
            out = tuple(t.pin_memory().to(dev, non_blocking=True)
                        for t in tensors)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def producer():
        # a producer crash must reach the consumer as an exception: an end
        # sentinel would finish training with fewer epochs than asked for
        try:
            for _ in range(num_epochs):
                if stop.is_set():
                    return
                item = upload(epoch_arrays(dataset, batch_size, num_batches))
                if not put_unless_stopped(item):
                    return
            put_unless_stopped(None)
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            put_unless_stopped(e)

    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def run():
        if side is not None:
            torch.cuda.set_device(dev)
        producer()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            tensors, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ready)
                for a in tensors:
                    a.record_stream(consumer)
            yield tensors
    finally:
        stop.set()
