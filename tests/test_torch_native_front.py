"""PyTorch port: the native HTTP front (`rag_serving_system_torch/native/
httpfront.cc` with `api/native_front.py`) over real TCP.

Every case of `tests/test_native_front.py`, run against the port's front,
queue and fake engine: a fake engine thread drains the in-memory queue
through the FrontQueue proxy (the BatchProcessor's place in the serving
process) while clients talk HTTP over sockets. Then one request script,
malformed requests included, goes to a JAX front and to a port front: the
status lines and bodies must be equal, with the minted `nf-` ids masked.
Skipped where there is no C++ compiler; a compiler that refuses the source
fails."""

from __future__ import annotations

import http.client
import json
import re
import shutil
import threading
import time

import pytest

from rag_serving_system_torch.core.request_queue import RequestQueue
from rag_serving_system_torch.native import get_httpfront_lib


@pytest.fixture(autouse=True)
def toolchain():
    if shutil.which("c++") is None:
        pytest.skip("no C++ compiler to build the native front")
    get_httpfront_lib()


class FakeEngine(threading.Thread):
    """Answers queued requests with 'ans:<query>' (optionally slowly)."""

    def __init__(self, queue, delay: float = 0.0, paused: bool = False):
        super().__init__(daemon=True)
        self.queue = queue
        self.delay = delay
        self.paused = threading.Event()
        if paused:
            self.paused.set()
        self.running = True

    def run(self):
        while self.running:
            if self.paused.is_set():
                time.sleep(0.01)
                continue
            batch = self.queue.get_batch()
            if self.delay:
                time.sleep(self.delay)
            for item in batch:
                self.queue.store_result(
                    item["id"], {"query": item["query"],
                                 "result": f"ans:{item['query']}",
                                 "k": item["k"]})


@pytest.fixture()
def front():
    """(port, FrontQueue, NativeFront, FakeEngine) with the engine running."""
    from rag_serving_system_torch.api.native_front import NativeFront, FrontQueue

    inner = RequestQueue(max_batch_size=8, max_wait_time=0.02)
    nf = NativeFront(inner, port=0).start()
    q = FrontQueue(inner, nf)
    eng = FakeEngine(q)
    eng.start()
    yield nf.port, q, nf, eng
    eng.running = False
    nf.stop()
    eng.join(timeout=5)


def _conn(port):
    return http.client.HTTPConnection("127.0.0.1", port, timeout=10)


def _post(conn, body, path="/rag"):
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_health(front):
    port = front[0]
    c = _conn(port)
    c.request("GET", "/health")
    r = c.getresponse()
    assert r.status == 200
    assert json.loads(r.read()) == {"status": "healthy"}


def test_sync_post_completes_in_exchange(front):
    port = front[0]
    c = _conn(port)
    status, body = _post(c, json.dumps({"query": "hello", "k": 3}),
                         "/rag?wait=10")
    assert status == 200
    assert body["status"] == "complete"
    assert body["request_id"].startswith("nf-")
    assert body["result"] == {"query": "hello", "result": "ans:hello", "k": 3}


def test_async_post_then_poll(front):
    port = front[0]
    c = _conn(port)
    status, body = _post(c, json.dumps({"query": "later"}))
    assert status == 200 and body["status"] == "processing"
    rid = body["request_id"]
    deadline = time.time() + 10
    while time.time() < deadline:
        c.request("GET", f"/rag/result/{rid}")
        r = c.getresponse()
        out = json.loads(r.read())
        if out["status"] == "complete":
            assert out["result"]["result"] == "ans:later"
            # consume-once: the second fetch sees processing
            c.request("GET", f"/rag/result/{rid}")
            assert json.loads(c.getresponse().read())["status"] == "processing"
            return
        time.sleep(0.02)
    pytest.fail("result never arrived")


def test_get_long_poll(front):
    port, _, _, eng = front
    eng.delay = 0.2  # force the result to land during the poll
    c = _conn(port)
    status, body = _post(c, json.dumps({"query": "slow"}))
    rid = body["request_id"]
    t0 = time.time()
    c.request("GET", f"/rag/result/{rid}?timeout=10")
    out = json.loads(c.getresponse().read())
    assert out["status"] == "complete"
    assert time.time() - t0 < 8  # woke on delivery, not at the deadline


def test_sync_post_times_out_to_processing_then_pollable(front):
    port, _, _, eng = front
    eng.paused.set()
    time.sleep(0.15)  # let an in-flight get_batch cycle finish first
    c = _conn(port)
    t0 = time.time()
    status, body = _post(c, json.dumps({"query": "parked"}), "/rag?wait=0.3")
    assert status == 200 and body["status"] == "processing"
    assert 0.2 <= time.time() - t0 < 5
    rid = body["request_id"]
    eng.paused.clear()  # engine resumes; result must be pollable
    deadline = time.time() + 10
    while time.time() < deadline:
        c.request("GET", f"/rag/result/{rid}")
        out = json.loads(c.getresponse().read())
        if out["status"] == "complete":
            return
        time.sleep(0.02)
    pytest.fail("post-timeout result was lost")


def test_keep_alive_reuse(front):
    port = front[0]
    c = _conn(port)
    for i in range(5):
        status, body = _post(c, json.dumps({"query": f"q{i}"}), "/rag?wait=10")
        assert status == 200 and body["result"]["result"] == f"ans:q{i}"


def test_json_edge_cases(front):
    port = front[0]
    c = _conn(port)
    # a "k" and a "query" INSIDE the query value must not confuse the parser;
    # escapes and unicode must round-trip
    tricky = 'He said "k": 99, {"query": null} \\ \n tab\t é 🎉'
    status, body = _post(
        c, json.dumps({"extra": {"k": 7}, "query": tricky, "k": 2}),
        "/rag?wait=10")
    assert status == 200
    assert body["result"]["query"] == tricky
    assert body["result"]["k"] == 2
    # \u escapes (incl. a surrogate pair) decode to UTF-8
    status, body = _post(
        c, '{"query": "caf\\u00e9 \\ud83c\\udf89", "k": 1}', "/rag?wait=10")
    assert status == 200
    assert body["result"]["query"] == "café 🎉"


@pytest.mark.parametrize("body", [
    "not json",
    "{}",                                  # missing query
    '{"query": 42}',                       # non-string query
    '{"query": "x", "k": 0}',              # k below bound
    '{"query": "x", "k": 2000}',           # k above bound
    '{"query": "x", "k": 2.5}',            # non-integer k
    '["query"]',                           # not an object
])
def test_validation_422(front, body):
    port = front[0]
    c = _conn(port)
    status, out = _post(c, body)
    assert status == 422
    assert "detail" in out


def test_404(front):
    port = front[0]
    c = _conn(port)
    c.request("GET", "/nope")
    assert c.getresponse().status == 404


def test_backpressure_503():
    from rag_serving_system_torch.api.native_front import NativeFront, FrontQueue

    inner = RequestQueue(max_batch_size=8, max_wait_time=0.02)
    nf = NativeFront(inner, port=0, max_inflight=2).start()
    q = FrontQueue(inner, nf)
    eng = FakeEngine(q, paused=True)  # nothing completes → inflight grows
    eng.start()
    try:
        c = _conn(nf.port)
        seen_503 = False
        for _ in range(4):
            status, _ = _post(c, json.dumps({"query": "x"}))
            if status == 503:
                seen_503 = True
        assert seen_503
        # completions free capacity again
        eng.paused.clear()
        deadline = time.time() + 10
        while time.time() < deadline:
            status, _ = _post(c, json.dumps({"query": "y"}))
            if status == 200:
                break
            time.sleep(0.05)
        assert status == 200
    finally:
        eng.running = False
        nf.stop()
        eng.join(timeout=5)


def test_concurrent_clients(front):
    port = front[0]
    errors: list[str] = []

    def worker(tag):
        try:
            c = _conn(port)
            for i in range(20):
                status, body = _post(
                    c, json.dumps({"query": f"{tag}-{i}"}), "/rag?wait=10")
                if status != 200 or body["result"]["result"] != f"ans:{tag}-{i}":
                    errors.append(f"{tag}-{i}: {status} {body}")
        except Exception as e:  # noqa: BLE001
            errors.append(f"{tag}: {e!r}")

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:5]


def test_stats_counters(front):
    port, _, nf, _ = front
    c = _conn(port)
    _post(c, json.dumps({"query": "s"}), "/rag?wait=10")
    _post(c, "broken")
    s = nf.stats()
    assert s["accepted"] >= 1
    assert s["completed"] >= 1
    assert s["bad_requests"] >= 1
    assert s["port"] == port


def test_pipelined_request_behind_waiter(front):
    """HTTP/1.1 pipelining: a request buffered behind a parked sync-POST must
    be answered as soon as the waiter is released (regression: it used to
    stall until the next EPOLLIN, which a pipelining client never sends)."""
    import socket

    port = front[0]
    body = json.dumps({"query": "pipelined"})
    req1 = (f"POST /rag?wait=10 HTTP/1.1\r\nHost: x\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n{body}")
    req2 = "GET /health HTTP/1.1\r\nHost: x\r\n\r\n"
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall((req1 + req2).encode())
    buf = b""
    deadline = time.time() + 10
    while buf.count(b"HTTP/1.1 200") < 2 and time.time() < deadline:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    s.close()
    assert buf.count(b"HTTP/1.1 200") == 2, buf[:400]
    assert b'"status": "complete"' in buf
    assert b'"healthy"' in buf


def test_foreign_nf_id_routes_to_python_store(front):
    """An nf- id with a DIFFERENT front tag (another replica / a restarted
    front) must go to the wrapped queue's result store, not be parked in
    this front's local map (regression: any nf- prefix was routed
    natively)."""
    port, q, nf, _ = front
    assert nf.id_prefix.startswith("nf-") and nf.id_prefix.endswith("-")
    foreign = "nf-deadbeef-000000000001"
    assert not foreign.startswith(nf.id_prefix)
    q.store_result(foreign, {"result": "foreign"})
    assert q.get_result(foreign, timeout=0)["result"] == "foreign"


def test_non_front_ids_still_use_python_store(front):
    """Results for uuid ids (aiohttp-submitted) keep flowing through the
    wrapped queue's result store."""
    port, q, _, _ = front
    rid = q.add_request("via python", 2)
    assert not rid.startswith("nf-")
    result = q.get_result(rid, timeout=10)
    assert result["result"] == "ans:via python"


def test_expect_100_continue(front):
    """A client sending Expect: 100-continue holds the body until the server's
    interim reply (curl does this for bodies >1KB and stalls ~1s without it).
    The front must send 100 Continue, then process the body normally."""
    import socket

    port = front[0]
    body = json.dumps({"query": "cont", "k": 1})
    head = (f"POST /rag?wait=10 HTTP/1.1\r\nHost: x\r\n"
            f"Content-Type: application/json\r\n"
            f"Expect: 100-continue\r\n"
            f"Content-Length: {len(body)}\r\n\r\n")
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(head.encode())
    buf = b""
    deadline = time.time() + 10
    while b"100 Continue" not in buf and time.time() < deadline:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    assert b"HTTP/1.1 100 Continue" in buf, buf[:200]
    s.sendall(body.encode())
    while b'"status": "complete"' not in buf and time.time() < deadline:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    s.close()
    assert b'"status": "complete"' in buf, buf[:400]


def test_enqueue_failure_releases_waiter():
    """If the Python enqueue raises after the front accepted a request, the
    waiter must get a synthetic error completion (not a silent timeout) and
    the C-side inflight counter must return to zero — otherwise repeated
    failures leak capacity toward permanent 503s under a max_inflight cap."""
    from rag_serving_system_torch.api.native_front import NativeFront, FrontQueue

    class ExplodingQueue(RequestQueue):
        def add_request_with_id(self, rid, query, k):
            raise RuntimeError("redis down")

    inner = ExplodingQueue(max_batch_size=8, max_wait_time=0.02)
    nf = NativeFront(inner, port=0, max_inflight=4).start()
    try:
        c = _conn(nf.port)
        status, body = _post(c, json.dumps({"query": "boom"}), "/rag?wait=10")
        assert status == 200
        assert body["status"] == "complete"
        assert body["result"]["status"] == "failed"
        assert "error" in body["result"]
        deadline = time.time() + 5
        while nf.stats()["inflight"] != 0 and time.time() < deadline:
            time.sleep(0.01)
        assert nf.stats()["inflight"] == 0
    finally:
        nf.stop()


def test_stats_reset_on_restart():
    """A restarted front must report fresh counters, not the previous
    instance's cumulative stats next to a zeroed inflight."""
    from rag_serving_system_torch.api.native_front import NativeFront, FrontQueue

    inner = RequestQueue(max_batch_size=8, max_wait_time=0.02)
    nf = NativeFront(inner, port=0).start()
    q = FrontQueue(inner, nf)
    eng = FakeEngine(q)
    eng.start()
    try:
        c = _conn(nf.port)
        _post(c, json.dumps({"query": "one"}), "/rag?wait=10")
        _post(c, "broken")
        s = nf.stats()
        assert s["accepted"] >= 1 and s["bad_requests"] >= 1
    finally:
        eng.running = False
        nf.stop()
        eng.join(timeout=5)
    nf2 = NativeFront(inner, port=0).start()
    try:
        s = nf2.stats()
        assert s == {"accepted": 0, "completed": 0, "rejected": 0,
                     "bad_requests": 0, "inflight": 0, "port": nf2.port}
    finally:
        nf2.stop()


# ---------------------------------------------------------------------------
# protocol fuzz: the C++ parser must never crash, hang, or wedge the front
# on hostile input — every case ends with the front still serving /health
# ---------------------------------------------------------------------------

import socket as _socket


def _raw(port, payload: bytes, read_timeout=2.0) -> bytes:
    s = _socket.create_connection(("127.0.0.1", port), timeout=read_timeout)
    try:
        s.sendall(payload)
        s.settimeout(read_timeout)
        chunks = []
        try:
            while True:
                b = s.recv(4096)
                if not b:
                    break
                chunks.append(b)
        except _socket.timeout:
            pass
        return b"".join(chunks)
    finally:
        s.close()


def _healthy(port) -> bool:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
    try:
        conn.request("GET", "/health")
        return conn.getresponse().status == 200
    finally:
        conn.close()


FUZZ_CASES = [
    b"",                                           # connect-then-close
    b"\r\n\r\n",
    b"GARBAGE NOT HTTP\r\n\r\n",
    b"GET\r\n\r\n",                                # no path/version
    b"POST /rag HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
    b"POST /rag HTTP/1.1\r\nContent-Length: abc\r\n\r\n{}",
    b"POST /rag HTTP/1.1\r\nContent-Length: 4\r\n\r\n{\"q",  # truncated body
    b"POST /rag HTTP/1.1\r\n\r\n" + b"A" * 100_000,          # no length, junk
    b"GET /rag/result/" + b"x" * 9000 + b" HTTP/1.1\r\n\r\n",  # huge path
    b"GET / HTTP/1.1\r\n" + b"X-H: y\r\n" * 5000 + b"\r\n",    # header flood
    b"POST /rag HTTP/1.0\r\nContent-Length: 26\r\n\r\n{\"query\": \"a\", \"k\": 1}\x00\x00\x00",
    "POST /rag HTTP/1.1\r\nContent-Length: 21\r\n\r\n{\"query\": \"éé\"}".encode(),
]


def test_fuzz_malformed_requests_never_wedge_the_front(front):
    port, _, _, _ = front
    for case in FUZZ_CASES:
        _raw(port, case)
        assert _healthy(port), f"front wedged after {case[:40]!r}"


def test_fuzz_pipelined_and_split_writes(front):
    port, _, _, _ = front
    # two pipelined POSTs in one segment
    body = b'{"query": "pipe", "k": 1}'
    one = (b"POST /rag?wait=5 HTTP/1.1\r\nContent-Type: application/json\r\n"
           + b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
    out = _raw(port, one + one, read_timeout=8.0)
    assert out.count(b"HTTP/1.1 200") == 2
    # byte-at-a-time trickle of a single valid request
    s = _socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        for i in range(0, len(one), 7):
            s.sendall(one[i:i + 7])
            time.sleep(0.001)
        s.settimeout(8.0)
        resp = s.recv(65536)
        assert b"200" in resp and b"ans:pipe" in resp
    finally:
        s.close()
    assert _healthy(port)


def test_fuzz_slowloris_does_not_block_other_clients(front):
    port, _, _, _ = front
    # a client that opens a request and never finishes the headers must not
    # stop other clients from being served (single-threaded epoll loop)
    s = _socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        s.sendall(b"POST /rag HTTP/1.1\r\nContent-Le")
        for _ in range(5):
            assert _healthy(port)
            time.sleep(0.05)
    finally:
        s.close()


# ---------------------------------------------------------------------------
# the port's front against the JAX package's, byte for byte
# ---------------------------------------------------------------------------

def _post_raw(body: str, path: str = "/rag") -> bytes:
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body.encode())}\r\n\r\n{body}").encode()


SCRIPT = [
    b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n",
    _post_raw('{"query": "same script", "k": 3}', "/rag?wait=10"),
    _post_raw('{"query": "caf\\u00e9 \\ud83c\\udf89", "k": 1}', "/rag?wait=10"),
    _post_raw("not json"),
    _post_raw("{}"),
    _post_raw('{"query": 42}'),
    _post_raw('{"query": "x", "k": 0}'),
    _post_raw('{"query": "x", "k": 2.5}'),
    _post_raw('["query"]'),
    b"GET /rag/result/nf-00000000-000000000099 HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GET /nope HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GARBAGE NOT HTTP\r\n\r\n",
    b"POST /rag HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
    b"POST /rag HTTP/1.1\r\nContent-Length: abc\r\n\r\n{}",
]


def _masked(raw: bytes) -> bytes:
    """The minted ids ("nf-<front tag>-<counter>") masked, and the Date
    header, if any, dropped."""
    raw = re.sub(rb"nf-[0-9a-f]+-[0-9a-f]+", b"nf-ID", raw)
    return re.sub(rb"Date: [^\r]*\r\n", b"", raw)


def _replay(port: int) -> list[bytes]:
    """Each request of SCRIPT on a connection of its own: the whole reply
    until the front closes the connection or stays silent."""
    out = []
    for req in SCRIPT:
        out.append(_masked(_raw(port, req, read_timeout=0.5)))
    return out


def test_same_script_same_replies_as_the_jax_front():
    from rag_serving_system_tpu.api import native_front as jax_front
    from rag_serving_system_tpu.core.request_queue import RequestQueue as JaxQueue
    from rag_serving_system_tpu.native import get_httpfront_lib as jax_lib
    from rag_serving_system_torch.api.native_front import NativeFront, FrontQueue

    if jax_lib() is None:
        pytest.skip("the JAX package's native front did not build")
    replies = []
    for front_cls, queue_cls in ((jax_front.NativeFront, JaxQueue), (NativeFront, RequestQueue)):
        inner = queue_cls(max_batch_size=8, max_wait_time=0.02)
        nf = front_cls(inner, port=0).start()
        q = (jax_front.FrontQueue if front_cls is jax_front.NativeFront else FrontQueue)(inner, nf)
        eng = FakeEngine(q)
        eng.start()
        try:
            replies.append(_replay(nf.port))
            stats = nf.stats()
        finally:
            eng.running = False
            nf.stop()
            eng.join(timeout=5)
        replies.append({k: v for k, v in stats.items() if k != "port"})
    jax_replies, jax_stats, ours, our_stats = replies
    # every request of the script but the last three gets a reply
    assert all(jax_replies[:-3]), jax_replies
    for i, (got, want) in enumerate(zip(ours, jax_replies)):
        assert got == want, (i, SCRIPT[i][:40], got[:300], want[:300])
    assert our_stats == jax_stats
