"""The chunked corpus fetch (``repro_torch.engines.base``), on the CPU.

A card's corpus comes back through a reused ring of staging buffers, chunk
by chunk.  Here the same loop runs from a CPU source through plain host
buffers, with the chunk size cut so that a corpus of 1,003 walks of 81
entries takes several chunks and a ragged last one: the copy is bitwise the
source's, a C-contiguous int32 array of its shape, in memory of its own (no
ring buffer is seen through it, and a later fetch leaves it as it was), the
ring is made once, and the counter says how many chunks were taken.
Threads that fetch at once take the ring in turn; a frame of the fetch
held past its return keeps no hold on the source; an engine on the CPU
hands its corpus over without a copy.
"""

import sys
import threading
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import spans  # noqa: E402
from repro_torch.engines import base  # noqa: E402

torch.set_num_threads(1)

CHUNK = 64 << 10
CPU = torch.device("cpu")


@pytest.fixture
def chunks(monkeypatch):
    """The chunk size cut to ``CHUNK``, spans on; yields a function that
    fetches ``src`` and returns (the array, the chunks it counted)."""
    monkeypatch.setattr(base, "FETCH_CHUNK_BYTES", CHUNK)
    spans.take()
    spans.enable()

    def fetch(src):
        out = base.fetch_corpus(src)
        _, counts = spans.take()
        return out, counts.get("corpus.fetch.chunks")

    try:
        yield fetch
    finally:
        spans.disable()
        spans.take()


def _corpus(walks: int, width: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-1, 1 << 30, (walks, width), dtype=torch.int32, generator=g)


def _ring_shares(out: np.ndarray) -> bool:
    return any(np.shares_memory(out, buf.numpy()) for buf in base._fetch_rings[CPU])


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("walks", [1003, 5, 0])
def test_chunked_fetch_is_a_bitwise_copy_of_its_own(monkeypatch, chunks, depth, walks):
    monkeypatch.setattr(base, "FETCH_RING", depth)
    src = _corpus(walks, 81, seed=walks)
    want = src.numpy().copy()
    out, n = chunks(src)
    assert n == -(-walks * 81 * 4 // CHUNK)
    assert n == {1003: 5, 5: 1, 0: 0}[walks]
    assert len(base._fetch_rings[CPU]) == depth
    assert out.dtype == np.int32 and out.shape == (walks, 81) and out.flags.c_contiguous
    assert out.tobytes() == want.tobytes()
    assert not np.shares_memory(out, src.numpy()) and not _ring_shares(out)


def test_a_later_fetch_leaves_the_first_as_it_was(chunks):
    a, b = _corpus(1003, 81, seed=1), _corpus(700, 81, seed=2)
    first, n_first = chunks(a)
    ring = [buf.data_ptr() for buf in base._fetch_rings[CPU]]
    second, n_second = chunks(b)
    assert (n_first, n_second) == (5, 4)
    # the ring is reused, not made again, and neither copy is seen through it
    assert [buf.data_ptr() for buf in base._fetch_rings[CPU]] == ring
    assert first.tobytes() == a.numpy().tobytes()
    assert second.tobytes() == b.numpy().tobytes()
    assert not _ring_shares(first) and not _ring_shares(second)
    assert not np.shares_memory(first, second)


def test_a_corpus_within_one_chunk_takes_one(chunks):
    walks = CHUNK // (81 * 4)
    src = _corpus(walks, 81, seed=3)
    out, n = chunks(src)
    assert n == 1 and out.tobytes() == src.numpy().tobytes()


def test_a_held_frame_of_the_fetch_keeps_no_hold_on_its_source(monkeypatch):
    """A stack sampler (a profiler's) may hold the fetch's frame past its
    return; the card's corpus must not live on in it."""
    frames = []
    monkeypatch.setattr(base.spans, "count", lambda name, n=1: frames.append(sys._getframe(1)))
    src = _corpus(1003, 81, seed=5)
    alive = weakref.ref(src)
    out = base.fetch_corpus(src)
    del src
    assert frames[0].f_code.co_name == "fetch_corpus"
    assert alive() is None and out.shape == (1003, 81)


def test_the_cpu_engine_hands_its_tensor_over(monkeypatch):
    """An engine on the CPU hands its corpus over: it never reaches the
    ring."""
    from repro_torch.core import erdos_renyi, partition_into_n_blocks, rwnv_task
    from repro_torch.engines import BiBlockEngine

    def refuse(src):
        raise AssertionError("the CPU engine fetched its corpus through the ring")

    bg = partition_into_n_blocks(erdos_renyi(200, 1000, seed=1), 3)
    task = rwnv_task(p=4.0, q=0.25, walks_per_vertex=2, length=6, seed=1)
    monkeypatch.setattr(base, "fetch_corpus", refuse)
    res = BiBlockEngine(bg, task, record_walks=True, device="cpu").run()
    assert res.corpus.dtype == np.int32 and res.corpus.shape == (400, 7)
    assert res.corpus.flags.c_contiguous and (res.corpus[:, 0] >= 0).all()


def test_threads_that_fetch_at_once_take_the_ring_in_turn(monkeypatch):
    monkeypatch.setattr(base, "FETCH_CHUNK_BYTES", 4096)
    sources = [_corpus(97 + i, 81, seed=10 + i) for i in range(16)]
    got = [None] * len(sources)

    def fetch(i):
        for _ in range(4):
            got[i] = base.fetch_corpus(sources[i])
            assert got[i].tobytes() == sources[i].numpy().tobytes()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fetch, args=(i,)) for i in range(len(sources))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for out, src in zip(got, sources):
        assert out is not None and out.tobytes() == src.numpy().tobytes()
