"""External plugin protocol — the go-plugin analog
(reference: plugins/base/, hashicorp/go-plugin handshake + gRPC broker).

The reference launches plugin binaries as subprocesses, performs a magic-
cookie handshake, and talks gRPC over a unix socket.  This module is the
same shape with Python-native parts: the host launches the plugin
executable with the cookie in the environment, the plugin binds a unix
socket and announces it on stdout with a go-plugin-style handshake line

    CORE-PROTOCOL|APP-PROTOCOL|unix|<socket path>|json

and both sides then speak length-prefixed JSON messages with request-id
multiplexing (so a blocked `wait_task` does not stall `stats` polls —
the same reason the reference multiplexes gRPC streams).

A plugin author writes:

    from nomad_tpu_torch.plugins import serve_driver
    class MyDriver(Driver): ...
    if __name__ == "__main__":
        serve_driver(MyDriver())

and ships the file; the client's PluginManager discovers it in
`plugin_dir`, launches it, and dispenses it like a built-in.
"""

from __future__ import annotations

import json
from collections import deque
import itertools
import os
import socket
import struct
import subprocess
import sys
import threading
from typing import Any, Callable, Dict, Optional

MAGIC_COOKIE_KEY = "NOMAD_TPU_PLUGIN_MAGIC_COOKIE"
MAGIC_COOKIE_VALUE = "nomad-tpu-plugin-f1a9"
SOCKET_ENV = "NOMAD_TPU_PLUGIN_SOCKET"
CORE_PROTOCOL = 1
APP_PROTOCOL = 1


class PluginError(Exception):
    pass


def _send(sock: socket.socket, obj: Dict) -> None:
    payload = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv(sock: socket.socket) -> Optional[Dict]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    body = b""
    while len(body) < n:
        chunk = sock.recv(n - len(body))
        if not chunk:
            return None
        body += chunk
    return json.loads(body)


class PluginClient:
    """Host-side connection to one plugin process: request-id multiplexed
    JSON-RPC over the handshaken unix socket."""

    def __init__(self, proc: subprocess.Popen, sock: socket.socket,
                 info: Dict) -> None:
        self.proc = proc
        self.sock = sock
        self.info = info                      # {type, name, version}
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._next_id = 0
        self._pending: Dict[int, list] = {}   # id -> [event, result, error]
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"plugin-{info.get('name')}")
        self._reader.start()

    _DEFAULT_TIMEOUT = 60.0

    def call(self, method: str, timeout: Any = "__default__",
             **params) -> Any:
        """`timeout=None` blocks until the plugin answers (wait_task on a
        long-running task); omitted -> 60s."""
        if timeout == "__default__":
            timeout = self._DEFAULT_TIMEOUT
        with self._lock:
            if self._closed:
                raise PluginError("plugin connection closed")
            self._next_id += 1
            rid = self._next_id
            waiter = [threading.Event(), None, None]
            self._pending[rid] = waiter
        # send OUTSIDE the registration lock: _read_loop needs it to
        # deliver responses, and a full socket buffer would otherwise
        # deadlock both directions.  The send lock alone keeps frames
        # from interleaving.
        try:
            with self._send_lock:
                # the send lock serializes exactly this (blocking)
                # socket write; nothing else is guarded by it
                _send(self.sock, {"id": rid,  # analyze: ok lockorder
                                  "method": method, "params": params})
        except OSError as e:
            with self._lock:
                self._pending.pop(rid, None)
            raise PluginError(f"plugin send failed: {e}") from e
        if not waiter[0].wait(timeout):
            with self._lock:
                self._pending.pop(rid, None)
            raise PluginError(f"plugin call {method} timed out")
        if waiter[2] is not None:
            raise PluginError(waiter[2])
        return waiter[1]

    def _read_loop(self) -> None:
        while True:
            try:
                msg = _recv(self.sock)
            except OSError:
                msg = None
            if msg is None:
                break
            with self._lock:
                waiter = self._pending.pop(msg.get("id"), None)
            if waiter is not None:
                waiter[1] = msg.get("result")
                waiter[2] = msg.get("error")
                waiter[0].set()
        # EOF: plugin died — fail everything in flight
        with self._lock:
            self._closed = True
            pending = list(self._pending.values())
            self._pending.clear()
        for waiter in pending:
            waiter[2] = "plugin process exited"
            waiter[0].set()

    def alive(self) -> bool:
        return not self._closed and self.proc.poll() is None

    def close(self) -> None:
        with self._lock:
            self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                self.proc.kill()


_LAUNCH_SEQ = itertools.count()


def launch_plugin(cmd, socket_dir: str, timeout: float = 60.0,
                  ) -> PluginClient:
    """Launch a plugin executable and perform the handshake
    (reference: go-plugin Client.Start)."""
    os.makedirs(socket_dir, exist_ok=True)
    env = dict(os.environ)
    env[MAGIC_COOKIE_KEY] = MAGIC_COOKIE_VALUE
    # plugins written against this SDK import nomad_tpu_torch; make sure the
    # child can resolve it regardless of its own cwd
    sdk_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    prev = env.get("PYTHONPATH", "")
    if sdk_root not in prev.split(os.pathsep):
        env["PYTHONPATH"] = (sdk_root + (os.pathsep + prev if prev else ""))
    sock_path = os.path.join(
        socket_dir, f"plugin-{os.getpid()}-{threading.get_ident()}-"
        f"{next(_LAUNCH_SEQ)}.sock")
    env[SOCKET_ENV] = sock_path
    # stderr is drained by a daemon thread into the bounded log ring —
    # NOT DEVNULL (a crashing child's traceback is the only diagnosis
    # there is), NOT an undrained pipe (blocks a chatty child at 64KB),
    # NOT a temp file (a long-lived chatty plugin would grow unlinked
    # disk invisibly).  The tail deque feeds launch-failure messages;
    # later stderr stays observable via `monitor`.
    from nomad_tpu_torch.core.logging import log as _log
    err_tail: deque = deque(maxlen=30)
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, env=env)
    except OSError as e:
        raise PluginError(f"plugin launch failed: {e}") from e

    def _drain(stream, label):
        # drain daemon thread: the pipe closing mid-read at plugin
        # shutdown is normal, not a reason to die with a traceback
        try:
            for raw in stream:
                line = raw.decode(errors="replace").rstrip()
                if line:
                    if label == "stderr":
                        err_tail.append(line)
                    _log("plugins", "debug", f"plugin {label}",
                         cmd=cmd[-1], line=line)
        except (OSError, ValueError):
            pass

    drain_t = threading.Thread(target=_drain,
                               args=(proc.stderr, "stderr"),
                               daemon=True, name="plugin-stderr")
    drain_t.start()
    tmp: Optional[PluginClient] = None
    try:
        line = _read_handshake_line(proc, timeout)
        # stdout drains from here on — BEFORE the plugin_info RPC: a
        # plugin print()ing >64KB between its handshake line and that
        # reply would wedge on the full pipe and time the launch out
        threading.Thread(target=_drain, args=(proc.stdout, "stdout"),
                         daemon=True, name="plugin-stdout").start()
        parts = line.strip().split("|")
        if len(parts) < 5 or parts[2] != "unix" or parts[4] != "json":
            raise PluginError(f"bad plugin handshake line: {line!r}")
        if not parts[0].isdigit() or int(parts[0]) != CORE_PROTOCOL:
            raise PluginError(
                f"plugin core protocol {parts[0]!r} unsupported")
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        try:
            sock.connect(parts[3])
        except OSError as e:
            raise PluginError(f"plugin socket connect failed: {e}") from e
        sock.settimeout(None)
        # identify (reference: base plugin PluginInfo RPC)
        tmp = PluginClient(proc, sock, {})
        info = tmp.call("plugin_info", timeout=timeout)
        tmp.info = info
        return tmp
    except Exception as e:
        # never leak the subprocess, and surface everything as PluginError
        # (WITH the child's stderr tail — the only diagnosis a startup
        # crash leaves) so callers have ONE failure type to supervise on
        if tmp is not None:
            tmp.close()
        elif proc.poll() is None:
            proc.kill()
        try:
            proc.wait(timeout=3)
            drain_t.join(timeout=1)   # let the tail settle before reading
        except Exception:  # noqa: BLE001 - diagnosis is best-effort
            pass
        msg = f"{e}" if isinstance(e, PluginError) else \
            f"plugin launch failed: {e}"
        try:
            tail = "\n".join(list(err_tail)[-8:])
        except RuntimeError:          # drain still appending: one retry
            tail = "\n".join(list(err_tail)[-8:])
        if tail:
            msg += f"; child stderr: {tail[-500:]}"
        raise PluginError(msg) from e


def _read_handshake_line(proc: subprocess.Popen, timeout: float) -> str:
    """Read the announcement line without blocking forever on a bad
    plugin (a plugin that prints nothing, or exits immediately)."""
    result: list = []

    def read():
        try:
            result.append(proc.stdout.readline().decode())
        except Exception as e:  # noqa: BLE001
            result.append(e)

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    if not result or isinstance(result[0], Exception) or not result[0]:
        proc.kill()
        raise PluginError("plugin did not announce its socket "
                          "(missing handshake line on stdout)")
    return result[0]


# --------------------------------------------------------------------------
# Plugin-side serve harness (reference: go-plugin plugin.Serve)
# --------------------------------------------------------------------------


def serve(handlers: Dict[str, Callable[..., Any]], info: Dict) -> None:
    """Run a plugin process: bind the socket from the environment,
    announce it, and serve JSON-RPC until the host disconnects.  Each
    request runs in its own thread so blocking calls (wait_task) don't
    stall the connection."""
    if os.environ.get(MAGIC_COOKIE_KEY) != MAGIC_COOKIE_VALUE:
        # lint: allow-print (pre-handshake: stderr is the only channel)
        print("this binary is a nomad-tpu plugin and must be launched "  # lint: allow-print
              "by the agent's plugin manager, not run directly",
              file=sys.stderr)
        sys.exit(1)
    sock_path = os.environ[SOCKET_ENV]
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(1)
    print(f"{CORE_PROTOCOL}|{APP_PROTOCOL}|unix|{sock_path}|json",  # lint: allow-print
          flush=True)
    conn, _ = srv.accept()
    send_lock = threading.Lock()

    def handle(msg: Dict) -> None:
        rid = msg.get("id")
        method = msg.get("method", "")
        out: Dict[str, Any] = {"id": rid}
        try:
            if method == "plugin_info":
                out["result"] = info
            else:
                fn = handlers.get(method)
                if fn is None:
                    raise PluginError(f"unknown method {method!r}")
                out["result"] = fn(**(msg.get("params") or {}))
        except Exception as e:  # noqa: BLE001 - surface to the host
            out["error"] = str(e)
        with send_lock:
            try:
                _send(conn, out)
            except OSError:
                pass

    while True:
        try:
            msg = _recv(conn)
        except OSError:
            break
        if msg is None:
            break
        threading.Thread(target=handle, args=(msg,), daemon=True).start()
    sys.exit(0)
