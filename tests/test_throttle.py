"""In-flight device-program throttle accounting.

The Decoder keeps at most two device programs in flight (enough to overlap
host and device work, and a bound on in-flight device memory); it
therefore RESERVES a slot before every dispatch and pairs each reservation with a backpressure token.
These tests pin the accounting: the bound holds under concurrent callers,
reservations never leak on error paths, and synchronize() drains to zero.
"""

import threading

import numpy as np
import pytest

from rocjpeg_tpu import api
from rocjpeg_tpu.status import RocJpegError
from rocjpeg_tpu.testing import encoder
from rocjpeg_tpu.types import DecodeParams, OutputFormat


@pytest.fixture(scope="module")
def blob():
    return encoder.encode_planes(
        encoder.random_planes("420", 128, 96, seed=3), "420",
        restart_interval=4)


def _state(dec):
    with dec._lock:
        return dec._outstanding, len(dec._inflight)


def test_synchronize_drains_to_zero(blob):
    dec = api.Decoder()
    streams = [api.JpegStream(blob)] * 4
    dec.decode_batched(streams)
    out, inflight = _state(dec)
    assert out == inflight  # every reservation has its token
    dec.synchronize()
    assert _state(dec) == (0, 0)
    # Idempotent.
    dec.synchronize()
    assert _state(dec) == (0, 0)


def test_bound_holds_under_concurrency(blob):
    """Sampled invariant: outstanding never exceeds max_inflight while
    eight threads hammer the same handle."""
    dec = api.Decoder()
    streams = [api.JpegStream(blob)] * 2
    seen = []
    stop = threading.Event()

    def sampler():
        while not stop.is_set():
            seen.append(_state(dec)[0])

    def worker():
        for _ in range(5):
            dec.decode_batched(streams)

    s = threading.Thread(target=sampler)
    s.start()
    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    stop.set()
    s.join()
    dec.synchronize()
    assert max(seen) <= dec._max_inflight
    assert _state(dec) == (0, 0)


def test_no_slot_leak_on_decode_error(blob):
    """A failing decode (corrupt stream via the host path) must release
    its reservation — otherwise two failures wedge the handle forever."""
    dec = api.Decoder()
    bad = bytearray(blob)
    # Truncate the scan hard enough that host decode raises.
    bad = bytes(bad[: len(bad) // 2])
    s = api.JpegStream()
    try:
        s.parse(bad)
    except RocJpegError:
        pytest.skip("truncation rejected at parse time on this corpus")
    for _ in range(4):  # > max_inflight: leaks would deadlock here
        with pytest.raises(RocJpegError):
            dec.decode(s)
    assert _state(dec)[0] == len(dec._inflight)
    dec.synchronize()
    assert _state(dec) == (0, 0)
    # The handle still works afterwards.
    good = dec.decode(api.JpegStream(blob),
                      DecodeParams(output_format=OutputFormat.Y))
    assert np.asarray(good.channel[0]).shape == (96, 128)
