"""Minimal blocking RESP2 client: the Redis queue's client when redis-py is
not installed.

A trimmed copy of `rag_serving_system_tpu/utils/resp.py`: the command
surface `RedisRequestQueue` speaks (RPUSH, LPOP, BLPOP, LLEN, LINDEX, GET,
SETEX, DEL, and a pipeline of LPOPs) against any RESP2 server, and PING,
SET, FLUSHALL and INFO for checking a server (the port's miniredis,
`native/miniredis.cc`, reports its memory count in INFO). Each exchange
checks a socket out of a pool of idle connections, so a BLPOP blocking one
connection never delays result stores from another thread. Values come back
as bytes.
"""

from __future__ import annotations

import socket
import threading
from urllib.parse import urlparse


class RespError(Exception):
    pass


class _Pipeline:
    """Queued LPOPs; execute() sends them in one write and reads all
    replies."""

    def __init__(self, client: "RespClient"):
        self._client = client
        self._cmds: list = []

    def lpop(self, key):
        self._cmds.append(("LPOP", key))
        return self

    def execute(self) -> list:
        cmds, self._cmds = self._cmds, []
        return self._client._exchange(cmds) if cmds else []


class _Conn:
    """One pooled socket and its read buffer."""

    __slots__ = ("sock", "buf")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""


class RespClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0, timeout: float | None = None, max_idle: int = 64):
        self._addr = (host, port)
        self._db = db
        self._timeout = timeout
        self._max_idle = max_idle
        self._lock = threading.Lock()   # guards the idle stack only
        self._idle: list[_Conn] = []

    @classmethod
    def from_url(cls, url: str) -> "RespClient":
        u = urlparse(url)
        db = int(u.path.lstrip("/") or 0) if u.path else 0
        return cls(u.hostname or "127.0.0.1", u.port or 6379, db=db)

    # -- connection pool -----------------------------------------------------

    def _dial(self) -> _Conn:
        s = socket.create_connection(self._addr, timeout=self._timeout or 10)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(self._timeout)
        conn = _Conn(s)
        if self._db:
            self._exchange_on(conn, [("SELECT", self._db)])
        return conn

    def _acquire(self) -> _Conn:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return self._dial()

    def _release(self, conn: _Conn) -> None:
        with self._lock:
            if len(self._idle) < self._max_idle:
                self._idle.append(conn)
                return
        self._discard(conn)

    @staticmethod
    def _discard(conn: _Conn) -> None:
        try:
            conn.sock.close()
        except OSError:
            pass

    def close(self) -> None:
        """Close the idle connections (one checked out closes on its own)."""
        with self._lock:
            idle, self._idle = self._idle, []
        for c in idle:
            self._discard(c)

    # -- wire ----------------------------------------------------------------

    @staticmethod
    def _encode(cmd: tuple) -> bytes:
        out = [b"*%d\r\n" % len(cmd)]
        for a in cmd:
            if isinstance(a, bytes):
                b = a
            elif isinstance(a, str):
                b = a.encode()
            elif isinstance(a, float):
                b = repr(a).encode()
            else:
                b = str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    @staticmethod
    def _fill(conn: _Conn) -> None:
        chunk = conn.sock.recv(65536)
        if not chunk:
            raise ConnectionError("redis connection closed")
        conn.buf += chunk

    def _read_reply(self, conn: _Conn):
        while b"\r\n" not in conn.buf:
            self._fill(conn)
        line, conn.buf = conn.buf.split(b"\r\n", 1)
        t, body = line[:1], line[1:]
        if t == b"+":
            return body
        if t == b"-":
            raise RespError(body.decode(errors="replace"))
        if t == b":":
            return int(body)
        if t == b"$":
            n = int(body)
            if n < 0:
                return None
            while len(conn.buf) < n + 2:
                self._fill(conn)
            data, conn.buf = conn.buf[:n], conn.buf[n + 2:]
            return data
        if t == b"*":
            n = int(body)
            return None if n < 0 else [self._read_reply(conn) for _ in range(n)]
        raise RespError(f"bad RESP type byte: {line!r}")

    def _exchange_on(self, conn: _Conn, cmds: list) -> list:
        conn.sock.sendall(b"".join(self._encode(c) for c in cmds))
        return [self._read_reply(conn) for _ in cmds]

    def _exchange(self, cmds: list) -> list:
        conn = self._acquire()
        try:
            out = self._exchange_on(conn, cmds)
        except (ConnectionError, OSError):
            # a pooled socket may have idled out: one fresh-dial retry
            self._discard(conn)
            conn = self._dial()
            try:
                out = self._exchange_on(conn, cmds)
            except (ConnectionError, OSError):
                self._discard(conn)
                raise
        self._release(conn)
        return out

    def _execute(self, *cmd):
        return self._exchange([cmd])[0]

    # -- the queue's command surface -----------------------------------------

    def rpush(self, key, *values) -> int:
        return self._execute("RPUSH", key, *values)

    def lpop(self, key):
        return self._execute("LPOP", key)

    def blpop(self, key, timeout=0):
        """(key, value) bytes or None, as redis-py returns them. The blocking
        connection is checked out of the pool, and its socket deadline runs
        past the server-side block timeout (none for timeout=0)."""
        conn = self._acquire()
        old = conn.sock.gettimeout()
        conn.sock.settimeout(timeout + 10 if timeout else None)
        try:
            conn.sock.sendall(self._encode(("BLPOP", key, timeout)))
            reply = self._read_reply(conn)
        except (ConnectionError, OSError):
            self._discard(conn)
            raise
        conn.sock.settimeout(old)
        self._release(conn)
        return tuple(reply) if reply else None

    def llen(self, key) -> int:
        return self._execute("LLEN", key)

    def lindex(self, key, index):
        return self._execute("LINDEX", key, index)

    def get(self, key):
        return self._execute("GET", key)

    def setex(self, key, ttl, value):
        return self._execute("SETEX", key, int(ttl), value)

    def delete(self, *keys) -> int:
        return self._execute("DEL", *keys)

    # -- checking a server ---------------------------------------------------

    def ping(self) -> bool:
        return self._execute("PING") in (b"PONG", b"OK")

    def set(self, key, value, ex=None):
        if ex is not None:
            return self._execute("SET", key, value, "EX", int(ex))
        return self._execute("SET", key, value)

    def flushall(self):
        return self._execute("FLUSHALL")

    def info(self) -> dict:
        """The INFO reply as {field: value}, ints where they parse (the
        port's miniredis reports `used_memory` and `maxmemory`)."""
        out = {}
        for line in (self._execute("INFO") or b"").decode().splitlines():
            if ":" in line and not line.startswith("#"):
                k, _, v = line.partition(":")
                try:
                    out[k] = int(v)
                except ValueError:
                    out[k] = v
        return out

    def pipeline(self) -> _Pipeline:
        return _Pipeline(self)


def client_from_url(url: str):
    """redis-py if installed, else RespClient: both speak the subset
    RedisRequestQueue needs."""
    try:
        import redis

        return redis.from_url(url)
    except ImportError:
        return RespClient.from_url(url)
