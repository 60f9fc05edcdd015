"""Control-channel transport: stdlib TCP, one JSON frame per connection.

Counterpart of ``mlsl_tpu.control.channel``, by copy. The control plane
rides its OWN socket fabric, not the device world: a wedged collective (a
hung kernel, a preempted neighbor) must never take down liveness detection,
because liveness detection is precisely what recovers
from it. The reference draws the same line — its endpoint servers own a
dedicated progress channel beside the data path (SURVEY §3).

Wire format: one newline-terminated JSON object per connection, sender
closes after writing. No acks — TCP either delivers the frame or raises on
the sender, and the membership layer (plane.py) is built on misses being
survivable. Frames carry HOST-READ SCALARS ONLY (rank, epoch, step counts,
status dicts already rendered to JSON-serializable values): the sending
thread never touches device state, so the A202 no-dispatch-off-thread rule
holds by construction, not by audit.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, Optional, Tuple

from mlsl_tpu_torch.log import log_debug, log_warning

#: hard cap on one frame's wire size: a status frame is a few KB; anything
#: bigger is a protocol bug, not a bigger buffer's job
MAX_FRAME_BYTES = 1 << 20

#: per-connection socket timeout: the channel is LAN/localhost control
#: traffic — a peer that cannot complete a tiny frame in this window is
#: indistinguishable from a dead one, and the heartbeat layer owns that call
CONNECT_TIMEOUT_S = 2.0


def send_frame(
    addr: Tuple[str, int],
    frame: dict,
    retries: int = 0,
    backoff_s: float = 0.2,
    timeout_s: float = CONNECT_TIMEOUT_S,
) -> None:
    """Deliver one frame to ``addr``; raises OSError when every attempt
    fails. ``retries`` follows the MLSL_DIST_INIT_RETRIES contract
    (attempts beyond the first, exponential backoff): heartbeats send with
    retries=0 — a miss is the signal — while membership commits and drain
    orders retry, because losing one is an availability event."""
    data = json.dumps(frame).encode("utf-8") + b"\n"
    if len(data) > MAX_FRAME_BYTES:
        raise ValueError(
            f"control frame exceeds {MAX_FRAME_BYTES} bytes "
            f"({len(data)}; type={frame.get('t')!r})"
        )
    last: Optional[OSError] = None
    for attempt in range(max(0, int(retries)) + 1):
        if attempt:
            time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            with socket.create_connection(addr, timeout=timeout_s) as s:
                s.sendall(data)
            return
        except OSError as e:
            last = e
    assert last is not None
    raise last


class Listener:
    """One accept-loop daemon thread delivering parsed frames to a handler.

    The handler runs ON the listener thread and must therefore stay
    host-only (plane.py's handlers update membership dicts and feed the
    straggler sentinel's host-side windows — no device dispatch, the same
    contract as the /metrics scrape handler). A malformed or oversized
    frame is dropped with a debug log: the channel survives garbage, the
    membership layer survives silence."""

    def __init__(self, addr: Tuple[str, int],
                 handler: Callable[[dict], None]):
        self._handler = handler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(addr)
        self._sock.listen(16)
        self._sock.settimeout(0.2)  # bounded accept wait -> prompt stop()
        self.addr = self._sock.getsockname()[:2]
        self.port = int(self.addr[1])
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name=f"mlsl-control-listen:{self.port}",
            daemon=True,
        )
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _peer = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # socket closed under us during stop()
            try:
                with conn:
                    conn.settimeout(CONNECT_TIMEOUT_S)
                    frame = self._read_frame(conn)
                if frame is not None:
                    self._handler(frame)
            except Exception as e:
                # one bad peer/frame must not kill liveness for everyone
                log_debug("control listener dropped a frame: %s: %s",
                          type(e).__name__, e)

    @staticmethod
    def _read_frame(conn: socket.socket) -> Optional[dict]:
        chunks = []
        size = 0
        while True:
            buf = conn.recv(65536)
            if not buf:
                break
            chunks.append(buf)
            size += len(buf)
            if size > MAX_FRAME_BYTES:
                log_warning("control frame over %d bytes dropped",
                            MAX_FRAME_BYTES)
                return None
            if buf.endswith(b"\n"):
                break
        if not size:
            return None
        doc = json.loads(b"".join(chunks).decode("utf-8"))
        return doc if isinstance(doc, dict) else None

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:  # pragma: no cover - defensive
            pass
        self._thread.join(timeout=5)
        if self._thread.is_alive():  # pragma: no cover - defensive
            log_warning("control listener thread did not stop within 5s")
