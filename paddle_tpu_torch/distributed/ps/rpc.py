"""Tiny length-prefixed pickle RPC (a copy of
``paddle_tpu/distributed/ps/rpc.py``: the same wire, so a trainer of
either package talks to a server of either; the brpc stand-in).

Reference: paddle/fluid/distributed/service/sendrecv.proto message
framing + brpc channel. One request/response per connection round; the
client keeps a persistent socket per server.
"""
import pickle
import socket
import struct

_HDR = struct.Struct("!Q")


def send_msg(sock, obj):
    payload = pickle.dumps(obj, protocol=4)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def recv_msg(sock):
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return pickle.loads(body)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def connect(host, port, timeout=30.0, retry_secs=60.0):
    """Connect with readiness retries: trainers routinely start before
    their servers have bound (reference: test_collective_base.py:37
    waits for endpoint readiness)."""
    import time
    deadline = time.time() + retry_secs
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
            break
        except (ConnectionRefusedError, OSError):
            if time.time() >= deadline:
                raise
            time.sleep(0.3)
    # blocking after connect: a receive timeout mid-request (e.g. a long
    # barrier wait) would desync the length-prefixed stream — the late
    # response would be read as the reply to the NEXT request
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock
