"""Asynchronous snapshot pipeline (the runtime I/O tier), as the JAX
package's `lbmdem_tpu/utils/async_io.py`.

Only the device->host copy stays on the solver thread (it must complete
BEFORE the next chunk writes into the state's f buffers); the file work
- VTK encode + write of multi-hundred-MB frames, trajectory CSV appends,
checkpoint writes - runs on a single background worker while the device
executes the next chunk.

Design rules:
- ONE worker thread: submissions execute in FIFO order, so appends
  (trajectory CSV) and frame sequences stay ordered without locks.
- Bounded queue (`max_pending`): a slow disk applies backpressure to
  the solver loop instead of buffering unbounded host RAM (a 4096^2
  fluid frame is ~260 MB of host arrays).
- Errors are never dropped: a failed write re-raises on the next
  submit() or at close(), wrapped with the original traceback.
- Callers must pass HOST data (numpy arrays, or CPU tensors copied off
  the state): the next chunk's steps overwrite the state's f buffers.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable


class AsyncWriter:
    """Bounded single-worker write pipeline; see module docstring."""

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, max_pending))
        self._err: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="lbmdem-async-io", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._err is None:  # fail-stop: skip work after an error
                    fn, args, kwargs = item
                    try:
                        fn(*args, **kwargs)
                    except BaseException as e:  # surfaced on submit/close
                        self._err = e
            finally:
                self._q.task_done()

    def submit(self, fn: Callable[..., Any], *args, **kwargs) -> None:
        """Queue fn(*args, **kwargs); blocks while max_pending frames
        are already in flight (backpressure). Raises a prior worker
        error instead of queueing more work after a failure."""
        if self._closed:
            raise RuntimeError("submit() after close()")
        self._raise_pending()
        self._q.put((fn, args, kwargs))

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(
                "asynchronous snapshot write failed (see cause)"
            ) from err

    def close(self) -> None:
        """Drain the queue, stop the worker, re-raise any write error."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._q.join()
        self._thread.join()
        self._raise_pending()

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, *exc) -> None:
        # on an exception in the body, still drain (partial frames are
        # better than lost frames) but do not mask the body's error
        try:
            self.close()
        except Exception:
            if exc[0] is None:
                raise
