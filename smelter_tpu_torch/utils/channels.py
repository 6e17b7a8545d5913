"""Bounded channels with deadline sends.

Python equivalent of the crossbeam bounded channels used between pipeline
stages in the reference (`smelter-core/src/pipeline/instance.rs:338-354`,
`queue/queue_thread.rs:270-285`): bounded capacity provides backpressure,
`send_deadline` drops late non-required payloads at the real-time boundary.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class Closed(Exception):
    pass


class Channel(Generic[T]):
    def __init__(self, capacity: int) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._closed = threading.Event()

    # -- sender side --------------------------------------------------------

    def send(self, item: T) -> None:
        """Blocking send (waits for space). Raises Closed if receiver closed."""
        while True:
            if self._closed.is_set():
                raise Closed()
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def send_deadline(self, item: T, deadline: float, clock=time.monotonic) -> bool:
        """Send unless `deadline` (clock timestamp) passes first.
        Returns False if the item was dropped."""
        while True:
            if self._closed.is_set():
                raise Closed()
            remaining = deadline - clock()
            if remaining <= 0:
                try:
                    self._q.put_nowait(item)
                    return True
                except queue.Full:
                    return False
            try:
                self._q.put(item, timeout=min(remaining, 0.1))
                return True
            except queue.Full:
                continue

    def try_send(self, item: T) -> bool:
        if self._closed.is_set():
            raise Closed()
        try:
            self._q.put_nowait(item)
            return True
        except queue.Full:
            return False

    def close(self) -> None:
        self._closed.set()

    # -- receiver side -------------------------------------------------------

    def recv(self, timeout: Optional[float] = None) -> T:
        """Blocking receive. Raises Closed when channel closed AND drained."""
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self._q.get_nowait()
            except queue.Empty:
                pass
            if self._closed.is_set():
                raise Closed()
            wait = 0.05
            if end is not None:
                rem = end - time.monotonic()
                if rem <= 0:
                    raise TimeoutError()
                wait = min(wait, rem)
            try:
                return self._q.get(timeout=wait)
            except queue.Empty:
                continue

    def try_recv(self) -> Optional[T]:
        """Non-blocking receive; None if empty. Raises Closed if closed+empty."""
        try:
            return self._q.get_nowait()
        except queue.Empty:
            if self._closed.is_set():
                raise Closed()
            return None

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def __len__(self) -> int:
        return self._q.qsize()

    def __bool__(self) -> bool:
        # a Channel is always truthy; without this, __len__ makes an *empty*
        # channel falsy, which silently breaks `if maybe_channel:` guards
        return True
