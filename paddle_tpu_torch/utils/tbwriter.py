"""A TensorBoard events-file scalar writer in the standard library alone
(the port's copy of ``paddle_tpu/utils/tbwriter.py``), which
``hapi.callbacks.VisualDL`` writes through: TFRecord framing (length +
masked crc32c) around hand-encoded ``tensorflow.Event`` protobufs
carrying ``Summary``/``simple_value`` scalars, readable by a stock
TensorBoard; ``read_scalars`` decodes such a file back, crc-checked.
"""
import os
import socket
import struct
import time

# ---- crc32c (Castagnoli), table-driven -------------------------------------

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data):
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---- protobuf wire encoding (the 4 shapes we need) -------------------------

def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field, wire):
    return _varint((field << 3) | wire)


def _pb_double(field, v):
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field, v):
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field, v):
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field, data):
    if isinstance(data, str):
        data = data.encode("utf-8")
    return _tag(field, 2) + _varint(len(data)) + data


def _event(wall_time, step=None, file_version=None, summary=None):
    """tensorflow.Event: wall_time=1 double, step=2 int64,
    file_version=3 string, summary=5 message."""
    buf = _pb_double(1, wall_time)
    if step is not None:
        buf += _pb_int64(2, step)
    if file_version is not None:
        buf += _pb_bytes(3, file_version)
    if summary is not None:
        buf += _pb_bytes(5, summary)
    return buf


def _scalar_summary(tag, value):
    """tensorflow.Summary{ value=1: { tag=1 string, simple_value=2 }}"""
    val = _pb_bytes(1, tag) + _pb_float(2, float(value))
    return _pb_bytes(1, val)


class SummaryWriter:
    """Append-only scalars writer producing a TensorBoard events file.

    API subset of visualdl.LogWriter / torch SummaryWriter:
    add_scalar(tag, value, step), flush(), close().
    """

    def __init__(self, logdir):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write_event(_event(time.time(),
                                 file_version="brain.Event:2"))

    def _write_event(self, payload):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag, value, step):
        self._write_event(_event(time.time(), step=int(step),
                                 summary=_scalar_summary(tag, value)))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_scalars(path):
    """Parse an events file back into {tag: [(step, value), ...]} —
    verification-grade decoder (crc-checked) used by tests."""
    out = {}
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (ln,) = struct.unpack_from("<Q", data, pos)
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert hcrc == _masked_crc(data[pos:pos + 8]), "header crc"
        payload = data[pos + 12:pos + 12 + ln]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + ln)
        assert pcrc == _masked_crc(payload), "payload crc"
        pos += 12 + ln + 4
        step, summary = 0, None
        p = 0
        while p < len(payload):
            key, p = _read_varint(payload, p)
            field, wire = key >> 3, key & 7
            if wire == 0:
                v, p = _read_varint(payload, p)
                if field == 2:
                    step = v
            elif wire == 1:
                p += 8
            elif wire == 5:
                p += 4
            elif wire == 2:
                ln2, p = _read_varint(payload, p)
                if field == 5:
                    summary = payload[p:p + ln2]
                p += ln2
        if summary:
            q = 0
            while q < len(summary):
                key, q = _read_varint(summary, q)
                if key >> 3 == 1 and key & 7 == 2:
                    vlen, q = _read_varint(summary, q)
                    val = summary[q:q + vlen]
                    q += vlen
                    tag, sv, r = None, None, 0
                    while r < len(val):
                        k2, r = _read_varint(val, r)
                        if k2 >> 3 == 1 and k2 & 7 == 2:
                            tl, r = _read_varint(val, r)
                            tag = val[r:r + tl].decode()
                            r += tl
                        elif k2 >> 3 == 2 and k2 & 7 == 5:
                            (sv,) = struct.unpack_from("<f", val, r)
                            r += 4
                        else:
                            break
                    if tag is not None:
                        out.setdefault(tag, []).append((step, sv))
    return out


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
