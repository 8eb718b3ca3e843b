"""Background batch prefetcher.

Reference: helpers/data_backend/runtime/batch_fetcher.py:51 (BatchFetcher) —
a daemon thread keeps a bounded queue of collated batches ahead of the train
step so host-side IO (cache reads, collate) overlaps device compute.  On TPU
this hides the .pt cache reads behind the XLA step; the queue passes
(raw_batch, epoch, iterator_state) snapshots so schedule windows, epoch
accounting AND checkpoint/resume stay exact under lookahead: a checkpoint
must persist the iterator state as of the last batch the trainer *consumed*,
not the producer's live cursor (which is up to `depth` batches ahead —
persisting it would skip those batches on resume).

The torch port's own copy of ``simpletuner_tpu/data/batch_fetcher.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional, Tuple


class BatchFetcher:
    def __init__(self, iterator, start_step: int = 0, depth: int = 10):
        self.iterator = iterator
        self._queue: "queue.Queue[Tuple[Dict[str, Any], int, Any]]" = queue.Queue(
            maxsize=max(1, depth)
        )
        self._step = start_step
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="batch-fetcher")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                raw = self.iterator.next_batch(step=self._step)
                # cursor state *after* this batch was drawn: cheap (sampler
                # cursors + rng tuple), and resuming from it replays the
                # sequence starting at the following batch
                state = self.iterator.save_state()
            except BaseException as exc:  # surfaced on the consumer side
                self._error = exc
                self._queue.put((None, -1, None))
                return
            item = (raw, self.iterator.epoch, state)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def next_batch(self) -> Tuple[Dict[str, Any], int, Any]:
        """Blocking fetch of the next (raw_batch, epoch, iterator_state)."""
        raw, epoch, state = self._queue.get()
        if raw is None:
            assert self._error is not None
            raise self._error
        return raw, epoch, state

    def stop(self) -> None:
        self._stop.set()
        # unblock the producer if it is waiting on a full queue
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
