"""ctypes bindings for the native host-runtime bridge (``cpp/rt_bridge.cpp``;
a copy of the JAX package's ``runtime/bridge.py``).

The shared library is built with g++ at first use into the repository's
``build/runtime/`` (``.gitignore`` lists ``build/``), never beside its
source: its name carries a hash of the source and the flags, so an edited
source builds anew, and a build is written under a temporary name and
renamed into place, so that concurrent processes never load half a file.
See ``rt_bridge.cpp`` for the design; this layer replaces the reference's
ROS1 transport/scheduling (TCPROS + rospy.Rate).

Messages are numpy arrays serialized as raw bytes with a tiny header
(u32 tag, u32 dtype code, u32 ndim, dims...), keeping the hot path
allocation-free on the C side. A message longer than one datagram (a
dense quadrotor reference is hundreds of KB) is sent as fragments of
``FRAGMENT_BYTES``, each behind a header (u32 ``FRAGMENT_MAGIC``, message
id, index, count), and the subscriber reassembles it; a message with a
lost fragment is dropped whole, as a lost datagram is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "cpp" / "rt_bridge.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

FRAGMENT_BYTES = 60000  # payload bytes per datagram of a long message
FRAGMENT_MAGIC = 0xFFFFFFF0  # never a tag: marks a fragment's header
FRAGMENT_GAP_S = 5e-4  # pause between fragments, for the receiver to drain

_build_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librt_bridge-{digest.hexdigest()[:12]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC}:\n{res.stdout}{res.stderr}")
    tmp.replace(so)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))

        lib.spsc_create.restype = ctypes.c_void_p
        lib.spsc_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.spsc_destroy.argtypes = [ctypes.c_void_p]
        lib.spsc_push.restype = ctypes.c_int
        lib.spsc_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_size_t]
        for f in (lib.spsc_pop, lib.spsc_pop_latest):
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                          ctypes.POINTER(ctypes.c_uint32)]
        lib.spsc_size.restype = ctypes.c_int
        lib.spsc_size.argtypes = [ctypes.c_void_p]

        lib.udp_pub_create.restype = ctypes.c_int
        lib.udp_pub_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.udp_send.restype = ctypes.c_int
        lib.udp_send.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_size_t]
        lib.udp_sub_create.restype = ctypes.c_int
        lib.udp_sub_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.udp_recv.restype = ctypes.c_int
        lib.udp_recv.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_size_t, ctypes.c_int]
        lib.udp_close.argtypes = [ctypes.c_int]

        lib.rate_create.restype = ctypes.c_void_p
        lib.rate_create.argtypes = [ctypes.c_double]
        lib.rate_sleep.restype = ctypes.c_double
        lib.rate_sleep.argtypes = [ctypes.c_void_p]
        lib.rate_destroy.argtypes = [ctypes.c_void_p]
        lib.monotonic_ns.restype = ctypes.c_uint64

        _lib = lib
        return _lib


# --------------------------------------------------------------- serialization

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64,
           4: np.uint8, 5: np.bool_}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def encode(tag: int, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    header = np.array(
        [tag, _DTYPE_CODES[arr.dtype], arr.ndim, *arr.shape], dtype=np.uint32
    )
    return header.tobytes() + arr.tobytes()


def decode(buf: bytes):
    head = np.frombuffer(buf[:12], dtype=np.uint32)
    tag, code, ndim = int(head[0]), int(head[1]), int(head[2])
    shape = tuple(
        np.frombuffer(buf[12:12 + 4 * ndim], dtype=np.uint32).tolist()
    )
    arr = np.frombuffer(buf[12 + 4 * ndim:], dtype=_DTYPES[code]).reshape(shape)
    return tag, arr


# ------------------------------------------------------------------- wrappers

class SpscQueue:
    """Wait-free SPSC handoff of numpy messages between two threads."""

    def __init__(self, slot_size: int = 4096, n_slots: int = 64):
        self._lib = get_lib()
        self._q = self._lib.spsc_create(slot_size, n_slots)
        self._slot_size = slot_size
        self._buf = ctypes.create_string_buffer(slot_size)

    def push(self, tag: int, arr: np.ndarray) -> bool:
        data = encode(tag, arr)
        r = self._lib.spsc_push(self._q, data, len(data))
        if r == -2:
            raise ValueError("message larger than slot size")
        return r == 0

    def _pop(self, fn):
        ln = ctypes.c_uint32(0)
        r = fn(self._q, self._buf, self._slot_size, ctypes.byref(ln))
        if r < 0 and r != -2:
            return None
        if r == -2:
            raise ValueError("message larger than receive buffer")
        return decode(self._buf.raw[: ln.value])

    def pop(self):
        """Oldest message or None."""
        return self._pop(self._lib.spsc_pop)

    def pop_latest(self):
        """Newest message (discarding older) or None — the 'control loop
        wants the freshest state' pattern."""
        return self._pop(self._lib.spsc_pop_latest)

    def __len__(self):
        return self._lib.spsc_size(self._q)

    def __del__(self):
        try:
            self._lib.spsc_destroy(self._q)
        except Exception:
            pass


class Publisher:
    """UDP datagram publisher (one topic = one port)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._lib = get_lib()
        self._fd = self._lib.udp_pub_create(host.encode(), port)
        if self._fd < 0:
            raise OSError(f"udp_pub_create failed for {host}:{port}")
        self._msg_id = 0

    def _send(self, data: bytes) -> None:
        if self._lib.udp_send(self._fd, data, len(data)) < 0:
            raise OSError("udp_send failed")

    def publish(self, tag: int, arr: np.ndarray) -> None:
        data = encode(tag, arr)
        if len(data) <= FRAGMENT_BYTES:
            self._send(data)
            return
        self._msg_id = (self._msg_id + 1) & 0xFFFFFFFF
        count = -(-len(data) // FRAGMENT_BYTES)
        for i in range(count):
            head = np.array([FRAGMENT_MAGIC, self._msg_id, i, count], np.uint32)
            if i:
                time.sleep(FRAGMENT_GAP_S)
            self._send(head.tobytes()
                       + data[i * FRAGMENT_BYTES:(i + 1) * FRAGMENT_BYTES])

    def close(self):
        self._lib.udp_close(self._fd)


class Subscriber:
    """UDP datagram subscriber bound to a port."""

    def __init__(self, port: int, max_len: int = 65536, rcvbuf: int = 1 << 20):
        self._lib = get_lib()
        self._fd = self._lib.udp_sub_create(port, rcvbuf)
        if self._fd < 0:
            raise OSError(f"udp_sub_create failed for port {port}")
        self._buf = ctypes.create_string_buffer(max_len)
        self._max_len = max_len
        self._frag_id = None  # the long message being reassembled
        self._frags: dict[int, bytes] = {}

    def _reassemble(self, buf: bytes):
        """The whole message once its last missing fragment ``buf`` is in,
        else None. A fragment of a newer message drops the partial one."""
        _, msg_id, i, count = (int(v) for v in np.frombuffer(buf[:16], np.uint32))
        if msg_id != self._frag_id:
            self._frag_id, self._frags = msg_id, {}
        self._frags[i] = buf[16:]
        if len(self._frags) < count:
            return None
        data = b"".join(self._frags[k] for k in range(count))
        self._frag_id, self._frags = None, {}
        return decode(data)

    def receive(self, timeout_ms: int = 100):
        """(tag, array) or None on timeout; a long message's fragments are
        received within the same timeout each."""
        while True:
            n = self._lib.udp_recv(self._fd, self._buf, self._max_len, timeout_ms)
            if n <= 0:
                return None
            buf = self._buf.raw[:n]
            if n < 16 or np.frombuffer(buf[:4], np.uint32)[0] != FRAGMENT_MAGIC:
                return decode(buf)
            msg = self._reassemble(buf)
            if msg is not None:
                return msg

    def close(self):
        self._lib.udp_close(self._fd)


class RateTimer:
    """Absolute-deadline periodic scheduler with lateness reporting."""

    def __init__(self, hz: float):
        self._lib = get_lib()
        self._r = self._lib.rate_create(hz)
        self.lateness = []

    def sleep(self) -> float:
        """Sleep to the next deadline; returns lateness [s]."""
        late = self._lib.rate_sleep(self._r)
        self.lateness.append(late)
        return late

    def jitter_stats(self):
        a = 1e3 * np.asarray(self.lateness)
        if len(a) == 0:
            return {}
        return {
            "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(np.max(a)),
            "overruns": int(np.sum(a > 1.0)),
        }

    def __del__(self):
        try:
            self._lib.rate_destroy(self._r)
        except Exception:
            pass


def monotonic_ns() -> int:
    return int(get_lib().monotonic_ns())
