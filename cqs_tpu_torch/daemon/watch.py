"""The watch daemon: filesystem reconcile loop + incremental reindex +
optional query server.

Port of ``cqs_tpu/daemon/watch.py`` over the port's pipeline, engine and
daemon server. A reconcile pass compares the files on disk with the store's
registry (mtime/size first, content hash second), reindexes the delta with
``run_index_pipeline`` and then calls ``SearchEngine.refresh_incremental``:
small deltas append into the device indexes' padding headroom or tombstone
rows, and past ``rebuild_threshold`` changes the indexes are rebuilt from
the store and swapped in. Queries served meanwhile may see stale but
consistent results, never rows of mixed generations (the engine's
``index_lock``). inotify events trigger a pass after a debounce window;
without inotify a periodic walk does.
"""

from __future__ import annotations

import signal
import time

from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.daemon.dispatch import BatchContext
from cqs_tpu_torch.daemon.server import DaemonServer
from cqs_tpu_torch.pipeline import run_index_pipeline
from cqs_tpu_torch.utils.trace import get_tracer
from cqs_tpu_torch.utils.walk import enumerate_files

log = get_tracer("watch")


class WatchLoop:
    def __init__(self, ctx: CommandContext, serve: bool = False):
        self.ctx = ctx
        self.serve = serve
        self.bctx = BatchContext(ctx, micro_batch=True)
        self.server: DaemonServer | None = None
        self._stop = False
        self._mutations = 0

    def reconcile_once(self) -> int:
        """One reconcile pass: fingerprint-compare disk vs store, reindex the
        delta. Returns number of changed files."""
        store = self.ctx.store
        registered = store.registered_origins()
        changed = 0
        seen = set()
        import os

        for f in enumerate_files(self.ctx.root):
            origin = str(f.relative_to(self.ctx.root))
            seen.add(origin)
            fp = registered.get(origin)
            if fp is None:
                changed += 1
                continue
            try:
                if not fp.matches_stat(os.stat(f)):
                    from cqs_tpu_torch.utils.hashing import fingerprint_file

                    if fingerprint_file(f).digest != fp.digest:
                        changed += 1
            except OSError:
                changed += 1
        removed = set(registered) - seen
        changed += len(removed)

        from cqs_tpu_torch.daemon import status as watch_status

        if changed:
            log.info("reconcile: %d changed files; reindexing", changed)
            watch_status.publish(self.ctx.index_dir, fresh=False,
                                 reindexing=changed, slot=self.ctx.slot)
            stats = run_index_pipeline(
                self.ctx.root, store, self.ctx.embedder, self.ctx._maybe_splade(),
                config=self.ctx.config)
            self._mutations += stats.chunks_upserted + stats.chunks_deleted
            self._refresh_indexes()
            watch_status.publish(self.ctx.index_dir, fresh=True, slot=self.ctx.slot,
                                 last_reindex_files=changed,
                                 last_reindex_s=stats.elapsed_s,
                                 chunks=store.chunk_count(),
                                 **self._ops_fields())
        else:
            watch_status.publish(self.ctx.index_dir, fresh=True, slot=self.ctx.slot,
                                 chunks=store.chunk_count(),
                                 **self._ops_fields())
        return changed

    def _ops_fields(self) -> dict:
        """Ops block for status snapshots (ref: the status --watch ops block,
        src/watch_status.rs): micro-batcher fusion stats once live."""
        stats = self.bctx.batcher_stats() if self.bctx is not None else None
        return {"batcher": stats} if stats else {}

    def _refresh_indexes(self) -> None:
        """Reconcile device indexes with the store: small deltas append into
        padding headroom / tombstone in place; large deltas trigger a full
        rebuild + atomic swap (engine.refresh_incremental)."""
        outcome = self.ctx.engine.refresh_incremental()
        log.info("index refresh: %s", outcome)
        self._mutations = 0

    def run(self, once: bool = False) -> int:
        if self.serve:
            self.bctx.warm()
            self.server = DaemonServer(self.bctx, self.ctx.index_dir)
            self.server.start()

        # two-phase shutdown (ref: src/cli/signal.rs): first signal asks the
        # loop to finish the current pass and exit cleanly; a second signal
        # within the grace window force-exits.
        def handle_signal(signum, frame):
            if self._stop:
                log.warning("second signal: force exit")
                raise SystemExit(130)
            log.info("signal received: finishing current pass then exiting "
                     "(signal again to force)")
            self._stop = True

        try:
            signal.signal(signal.SIGTERM, handle_signal)
            signal.signal(signal.SIGINT, handle_signal)
        except ValueError:
            pass     # not main thread (tests)

        interval = default_limits.reconcile_interval_s
        debounce = default_limits.watch_debounce_ms / 1e3
        watcher = None
        try:
            from cqs_tpu_torch.daemon.inotify import InotifyUnavailable, InotifyWatcher

            try:
                watcher = InotifyWatcher(self.ctx.root)
                log.info("inotify watcher active (%d dirs)", len(watcher._wd_to_dir))
            except InotifyUnavailable as e:
                log.info("inotify unavailable (%s); polling reconcile", e)
        except Exception as e:   # non-Linux libc quirks must not kill watch
            log.info("inotify setup failed (%s); polling reconcile", e)
        try:
            self.reconcile_once()
            if once:
                return 0
            next_walk = time.time() + min(interval, 5.0)
            while not self._stop:
                if watcher is not None:
                    # event-driven: change-to-fresh latency = the debounce
                    # window, not the reconcile interval (ref: debounced
                    # notify pipeline, src/cli/watch/mod.rs:572)
                    events = watcher.poll(timeout_s=1.0, settle_s=debounce)
                    if events or watcher.overflowed:
                        self.reconcile_once()
                        watcher._n_overflow = 0
                else:
                    time.sleep(max(debounce, 0.25))
                if time.time() >= next_walk:
                    self.reconcile_once()    # periodic backstop walk
                    next_walk = time.time() + min(interval, 30.0)
                    if self.serve and self.bctx.maybe_idle_unload():
                        log.info("idle: unloaded device model state")
        finally:
            if watcher is not None:
                watcher.close()
            if self.server is not None:
                self.server.stop()
            self.bctx.close()
        return 0


def run_watch(ctx: CommandContext, serve: bool = False, once: bool = False) -> int:
    return WatchLoop(ctx, serve=serve).run(once=once)
