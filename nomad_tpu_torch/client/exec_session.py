"""Interactive exec sessions: streamed stdout + streamed stdin over the
HTTP API.

The reference's `nomad alloc exec -i` is a websocket carrying stdin and
stdout frames (command/alloc_exec.go; drivers' ExecTaskStreaming).  The
stdlib HTTP server here has no websockets, so the same bidirectional
stream is re-designed as a SESSION + chunked long-poll:

  POST /v1/client/allocation/:id/exec {"Interactive": true, ...}
      -> {"SessionId": sid}            spawn + register
  GET  .../exec/:sid/stream?offset=N   long-poll: blocks until output
      beyond N exists (or exit), returns {"Data", "Offset", "Exited",
      "ExitCode"} — the client loops, carrying the offset cursor
  POST .../exec/:sid/stdin {"Data": b64} | {"Eof": true}
      -> keystrokes / EOF toward the process

Both the CLI (`alloc exec -i`) and the web UI terminal consume these.

A session owns a reader thread draining the driver's ExecStream into a
bounded buffer under a condition variable; `wait_output` is the
long-poll primitive.  The registry reaps exited sessions after a grace
period and idle sessions after a TTL (a vanished client must not leak
processes).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from nomad_tpu_torch.structs import new_id

# output kept per session; older bytes drop off (the CLI consumes live)
MAX_BUFFER = 4 << 20
EXITED_GRACE_S = 120.0     # reap this long after exit (client reads tail)
IDLE_TTL_S = 600.0         # reap sessions nobody polls


class ExecStream:
    """Driver-side contract for one interactive exec (what
    BaseDriver.open_exec returns).  Subprocess drivers wrap a Popen;
    the mock driver fakes a shell."""

    def read(self, max_bytes: int = 4096) -> bytes:
        """Blocking read of combined output; b'' = EOF."""
        raise NotImplementedError

    def write_stdin(self, data: bytes) -> None:
        raise NotImplementedError

    def close_stdin(self) -> None:
        raise NotImplementedError

    def exit_code(self) -> Optional[int]:
        """None while running."""
        raise NotImplementedError

    def terminate(self) -> None:
        raise NotImplementedError


class PopenExecStream(ExecStream):
    """ExecStream over a subprocess.Popen with piped stdio (stderr
    merged — the reference's exec stream multiplexes frames; combined
    output keeps the long-poll protocol single-cursor)."""

    def __init__(self, proc) -> None:
        self.proc = proc

    def read(self, max_bytes: int = 4096) -> bytes:
        return self.proc.stdout.read1(max_bytes)

    def write_stdin(self, data: bytes) -> None:
        self.proc.stdin.write(data)
        self.proc.stdin.flush()

    def close_stdin(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass

    def exit_code(self) -> Optional[int]:
        return self.proc.poll()

    def terminate(self) -> None:
        try:
            self.proc.terminate()
        except OSError:
            pass


class ExecSession:
    """One live interactive exec: reader thread + bounded buffer +
    long-poll cursor."""

    def __init__(self, stream: ExecStream, alloc_id: str = "",
                 task: str = "") -> None:
        self.id = new_id()
        self.alloc_id = alloc_id
        self.task = task
        self.stream = stream
        self._cv = threading.Condition()
        self._buf = bytearray()
        self._base = 0              # offset of _buf[0] in the full stream
        self.exited = False
        self.exit_code: Optional[int] = None
        self.exit_time = 0.0
        self.last_touch = time.monotonic()
        self._reader = threading.Thread(target=self._drain, daemon=True,
                                        name=f"exec-{self.id[:8]}")
        self._reader.start()

    def _drain(self) -> None:
        while True:
            try:
                chunk = self.stream.read(4096)
            except (OSError, ValueError):
                chunk = b""
            with self._cv:
                if chunk:
                    self._buf += chunk
                    if len(self._buf) > MAX_BUFFER:
                        drop = len(self._buf) - MAX_BUFFER
                        del self._buf[:drop]
                        self._base += drop
                else:
                    self.exited = True
                    self.exit_code = self.stream.exit_code()
                    self.exit_time = time.monotonic()
                self._cv.notify_all()
            if not chunk:
                return

    # ------------------------------------------------------------- client

    def wait_output(self, offset: int, timeout: float = 25.0
                    ) -> Tuple[bytes, int, bool, Optional[int]]:
        """Long-poll: block until output beyond `offset` exists or the
        process exits (or timeout).  Returns (data, new_offset, exited,
        exit_code)."""
        self.last_touch = time.monotonic()
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                end = self._base + len(self._buf)
                if offset < end or self.exited:
                    lo = max(offset - self._base, 0)
                    data = bytes(self._buf[lo:])
                    return data, end, self.exited, self.exit_code
                left = deadline - time.monotonic()
                if left <= 0:
                    return b"", offset, False, None
                self._cv.wait(left)

    def stdin(self, data: bytes) -> None:
        self.last_touch = time.monotonic()
        self.stream.write_stdin(data)

    def stdin_eof(self) -> None:
        self.stream.close_stdin()

    def close(self) -> None:
        self.stream.terminate()


class ExecSessionRegistry:
    """Sessions by id, with reaping (see module docstring).  A daemon
    timer sweeps even when no further exec traffic arrives — a vanished
    client (crashed browser tab) must not leak its shell process until
    the next unrelated request."""

    REAP_INTERVAL_S = 60.0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sessions: Dict[str, ExecSession] = {}
        self._sweeper_started = False

    def _sweep(self) -> None:
        while True:
            time.sleep(self.REAP_INTERVAL_S)
            # the reaper daemon thread must survive a terminate() racing
            # a session's shell process going away mid-reap
            try:
                with self._lock:
                    self._reap_locked()
            except Exception:  # noqa: BLE001 - keep the sweeper alive
                pass

    def add(self, session: ExecSession) -> str:
        with self._lock:
            if not self._sweeper_started:
                self._sweeper_started = True
                threading.Thread(target=self._sweep, daemon=True,
                                 name="exec-session-reaper").start()
            self._reap_locked()
            self._sessions[session.id] = session
            return session.id

    def get(self, sid: str) -> Optional[ExecSession]:
        with self._lock:
            self._reap_locked()
            return self._sessions.get(sid)

    def remove(self, sid: str) -> None:
        with self._lock:
            s = self._sessions.pop(sid, None)
        if s is not None:
            s.close()

    def _reap_locked(self) -> None:
        now = time.monotonic()
        dead = [sid for sid, s in self._sessions.items()
                if (s.exited and now - s.exit_time > EXITED_GRACE_S)
                or now - s.last_touch > IDLE_TTL_S]
        for sid in dead:
            s = self._sessions.pop(sid)
            s.close()
