"""Device executor: funnels all device work onto one thread.

The reference serializes device-adjacent work through a blocking pool of
pre-built executors (ExecutorPool, reference db/execution/
executor_pool.hpp:10-46). This engine's equivalent is a single device
executor thread: request-handler threads submit closures and wait on
futures; the executor drains the queue in order, which matches the
one-device execution model (kernels are batched, not parallel).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, Optional


class DeviceExecutor:
    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._thread_id: Optional[int] = None
        self._stop = threading.Event()
        # Serializes inline execution when no loop is active (library
        # mode): concurrent callers must not hit the device together.
        self._inline_lock = threading.Lock()

    # ---- executor side ------------------------------------------------

    def run_loop(self) -> None:
        """Drain submitted work until stop() — call from the thread that
        should own the device (typically the process main thread). Work
        still queued when the loop ends is cancelled, so its waiters raise
        CancelledError instead of waiting forever."""
        self._thread_id = threading.get_ident()
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            fn, args, kwargs, fut = item
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn(*args, **kwargs))
                except BaseException as e:  # propagate to the waiter
                    fut.set_exception(e)
        self._thread_id = None
        while True:
            try:
                self._queue.get_nowait()[3].cancel()
            except queue.Empty:
                break

    def stop(self) -> None:
        """Ask run_loop() to return after the work item in progress (safe
        to call from a signal handler: it only sets an event)."""
        self._stop.set()

    @property
    def loop_active(self) -> bool:
        """True when a run_loop() thread currently owns the device
        (server mode); False in library mode, where run() executes
        inline on the caller."""
        return self._thread_id is not None

    # ---- caller side --------------------------------------------------

    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        fut: Future = Future()
        self._queue.put((fn, args, kwargs, fut))
        return fut

    def run(self, fn: Callable, *args, **kwargs):
        """Run fn on the executor thread; directly (under an inline lock,
        so concurrent library-mode callers stay serialized) when no loop is
        active or we already are the executor thread."""
        if threading.get_ident() == self._thread_id:
            return fn(*args, **kwargs)
        if self._thread_id is None:
            with self._inline_lock:
                if self._thread_id is None:  # loop may have started
                    return fn(*args, **kwargs)
        return self.submit(fn, *args, **kwargs).result()
