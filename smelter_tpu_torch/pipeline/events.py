"""Global pipeline event emitter.

Pub-sub fan-out of pipeline events (input delivered/playing/EOS, output done)
to any number of subscribers — the analogue of the reference's
global emitter (`smelter-render/src/event_handler.rs:16-31`) + pipeline event
mapping (`smelter-core/src/event.rs:14-29`). Subscribers receive events on
their own unbounded queue; the WS route drains one per connection.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import List


@dataclass(frozen=True)
class Event:
    kind: str            # e.g. "VIDEO_INPUT_EOS", "OUTPUT_DONE"
    entity_id: str       # input or output id
    properties: dict = field(default_factory=dict, hash=False, compare=False)


# queue-side kinds → wire event kinds (reference event.rs:45+)
_QUEUE_KIND_MAP = {
    ("video", "delivered"): "VIDEO_INPUT_DELIVERED",
    ("video", "playing"): "VIDEO_INPUT_PLAYING",
    ("video", "paused"): "VIDEO_INPUT_PAUSED",
    ("video", "eos"): "VIDEO_INPUT_EOS",
    ("audio", "delivered"): "AUDIO_INPUT_DELIVERED",
    ("audio", "playing"): "AUDIO_INPUT_PLAYING",
    ("audio", "paused"): "AUDIO_INPUT_PAUSED",
    ("audio", "eos"): "AUDIO_INPUT_EOS",
}


class Emitter:
    """Thread-safe event fan-out."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._subscribers: List[queue.SimpleQueue] = []
        self._history: List[Event] = []

    def subscribe(self) -> "queue.SimpleQueue[Event]":
        q: queue.SimpleQueue = queue.SimpleQueue()
        with self._lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, q: queue.SimpleQueue) -> None:
        with self._lock:
            try:
                self._subscribers.remove(q)
            except ValueError:
                pass

    def emit(self, event: Event) -> None:
        with self._lock:
            self._history.append(event)
            subs = list(self._subscribers)
        for q in subs:
            q.put(event)

    def emit_queue_event(self, input_id: str, kind: str) -> None:
        """Translate a sync-queue event ('delivered'/'playing'/'eos', possibly
        prefixed 'audio:') into a wire event."""
        media = "video"
        if kind.startswith("audio:"):
            media, kind = "audio", kind.split(":", 1)[1]
        wire = _QUEUE_KIND_MAP.get((media, kind))
        if wire:
            self.emit(Event(wire, input_id))

    def history(self) -> List[Event]:
        with self._lock:
            return list(self._history)
