"""Worker threads read through the port's store while the home thread
writes: every worker has its own read-only connection, sees only committed
states, and is never handed the home connection.

The fault this pins: a worker thread that reads through the home connection
(``Store.chunk_count`` did, under ``fts_search``) shares that connection's
cached prepared statements with every other thread, and one thread's step
takes another's row: ``fetchone()`` returns None. Tolerances: none."""

import sqlite3
import sys
import threading

import pytest

from cqs_tpu_torch.parser.types import Chunk, ChunkType
from cqs_tpu_torch.store import Store

N_THREADS = 8
BATCH = 10


def _chunks(lo: int, hi: int) -> list[Chunk]:
    return [Chunk(origin=f"f{i // BATCH}.py", name=f"f{i}", chunk_type=ChunkType.FUNCTION,
                  language="python", line_start=i, line_end=i, signature=f"def f{i}()",
                  doc="", body=f"def f{i}(): pass") for i in range(lo, hi)]


@pytest.fixture
def fast_switching():
    # more thread switches inside the store's methods than the default 5 ms
    # interval gives
    prior = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(prior)


def test_workers_read_while_home_thread_writes(tmp_path, fast_switching):
    st = Store(tmp_path / "index.db")
    ids = st.upsert_chunks(_chunks(0, 50), ["nl"] * 50, ["nl"] * 50)
    stop = threading.Event()
    errors: list[BaseException] = []
    counts: list[set[int]] = [set() for _ in range(N_THREADS)]
    conns: list[sqlite3.Connection] = []

    def worker(k: int) -> None:
        try:
            conns.append(st._read_db())
            rounds = 0
            while rounds < 30 or not stop.is_set():
                rows = st.get_chunks_by_ids(ids[:20])
                assert len(rows) == 20
                st.fts_search("def", limit=10)      # reads chunk_count on the way
                assert st.get_chunk(ids[0]).id == ids[0]
                counts[k].add(st.chunk_count())
                assert st.stats()["chunks"] >= 50
                assert len(st.find_by_name("f3")) == 1
                rounds += 1
                if rounds > 2000:
                    break
        except BaseException as e:          # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(N_THREADS)]
    for t in threads:
        t.start()
    # the home thread writes whole batches while the workers read
    for b in range(5, 15):
        st.upsert_chunks(_chunks(b * BATCH, (b + 1) * BATCH), ["nl"] * BATCH, ["nl"] * BATCH)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    # a worker sees committed states only: whole batches, never part of one
    seen = set().union(*counts)
    assert seen and all(n % BATCH == 0 and 50 <= n <= 150 for n in seen), seen
    # every worker had a connection of its own, none the home connection
    assert len(conns) == N_THREADS and len({id(c) for c in conns}) == N_THREADS
    assert all(c is not st.db for c in conns)
    assert st.chunk_count() == 150 and st._read_db() is st.db
    st.close()


def test_failed_read_only_open_raises_and_never_shares(tmp_path, monkeypatch):
    st = Store(tmp_path / "index.db")
    st.upsert_chunks(_chunks(0, 5), ["nl"] * 5, ["nl"] * 5)
    real_connect = sqlite3.connect
    attempts = []

    def refuse_read_only(target, *a, **kw):
        if isinstance(target, str) and target.endswith("?mode=ro"):
            attempts.append(target)
            raise sqlite3.OperationalError("unable to open database file")
        return real_connect(target, *a, **kw)

    monkeypatch.setattr(sqlite3, "connect", refuse_read_only)
    got: list[object] = []

    def worker() -> None:
        for call in (st._read_db, st.chunk_count, lambda: st.get_chunk("x")):
            try:
                got.append(call())
            except sqlite3.OperationalError as e:
                got.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(got) == 3 and all(isinstance(g, sqlite3.OperationalError) for g in got), got
    assert len(attempts) == 9          # three tries per call, then the error
    # the home thread is untouched by the refusal
    assert st.chunk_count() == 5
    st.close()


def test_read_only_open_is_retried(tmp_path, monkeypatch):
    st = Store(tmp_path / "index.db")
    st.upsert_chunks(_chunks(0, 5), ["nl"] * 5, ["nl"] * 5)
    real_connect = sqlite3.connect
    attempts = []

    def fail_once(target, *a, **kw):
        if isinstance(target, str) and target.endswith("?mode=ro"):
            attempts.append(target)
            if len(attempts) == 1:
                raise sqlite3.OperationalError("unable to open database file")
        return real_connect(target, *a, **kw)

    monkeypatch.setattr(sqlite3, "connect", fail_once)
    got: list[object] = []
    t = threading.Thread(target=lambda: got.append((st._read_db(), st.chunk_count())))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(attempts) == 2 and got[0][0] is not st.db and got[0][1] == 5
    st.close()


class _NotedConnection:
    """The store's home (writer) connection, with every thread that runs SQL
    through it noted."""

    def __init__(self, conn: sqlite3.Connection):
        self._conn = conn
        self.threads: set[int] = set()

    def _noted(self, name):
        def call(*a, **kw):
            self.threads.add(threading.get_ident())
            return getattr(self._conn, name)(*a, **kw)
        return call

    def __getattr__(self, name):
        if name in ("execute", "executemany", "executescript", "cursor"):
            return self._noted(name)
        return getattr(self._conn, name)

    def __enter__(self):
        return self._conn.__enter__()

    def __exit__(self, *exc):
        return self._conn.__exit__(*exc)


#: the analysis requests a daemon's client threads send while the watch
#: loop writes: each reads the store through ``analysis/{context,quality,
#: callgraph}.py``
ANALYSIS_REQUESTS = (("onboard", {}), ("health", {}), ("suggest", {}),
                     ("related", {"name": "f3"}))


def test_analysis_reads_while_the_watch_loop_writes(tmp_path, fast_switching):
    # the daemon's threads: client threads ask the dispatch table for
    # analysis commands (serialized among themselves by BatchContext.lock)
    # while the watch loop's thread, the store's home thread, upserts whole
    # files without that lock. No request may run SQL through the writer's
    # connection: there it would share cached statements with the writer
    # and read its uncommitted rows.
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.daemon.dispatch import BatchContext

    (tmp_path / ".cqs-tpu").mkdir()
    ctx = CommandContext.create(str(tmp_path), device="cpu")
    st = ctx.store
    st.upsert_chunks(_chunks(0, 5 * BATCH), ["nl"] * 5 * BATCH, ["nl"] * 5 * BATCH)
    writer = _NotedConnection(st.db)
    st.db = writer
    bctx = BatchContext(ctx)
    stop = threading.Event()
    errors: list[object] = []
    files_seen: list[set[int]] = [set() for _ in range(N_THREADS)]

    def client(k: int) -> None:
        try:
            rounds = 0
            while rounds < 10 or not stop.is_set():
                for command, args in ANALYSIS_REQUESTS:
                    resp = bctx.dispatch(command, args)
                    if "error" in resp:
                        errors.append((command, resp["error"]))
                        return
                    if command == "onboard":
                        # one file a write: a committed state holds whole files
                        sizes = [f["chunks"] for f in resp["results"]["largest_files"]]
                        assert sizes and set(sizes) == {BATCH}, sizes
                        files_seen[k].add(len(sizes))
                rounds += 1
                if rounds > 400:
                    break
        except BaseException as e:          # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(N_THREADS)]
    for t in threads:
        t.start()
    for b in range(5, 10):
        st.upsert_chunks(_chunks(b * BATCH, (b + 1) * BATCH), ["nl"] * BATCH, ["nl"] * BATCH)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    try:
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert writer.threads == {threading.get_ident()}, "a client thread read through the writer"
        assert set().union(*files_seen) <= set(range(5, 11))
    finally:
        st.db = writer._conn
        bctx.close()
        ctx.close()
