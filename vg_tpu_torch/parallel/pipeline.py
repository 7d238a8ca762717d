"""Threaded host pipeline for the mapping loop.

The reference overlaps reading, mapping, and emission with OpenMP threads
(vg::io::for_each_parallel). vg_tpu's host stages are dominated by
GIL-releasing work — native C kernels (seeding, GAM encoding), numpy, the
device DP, and zlib — so a small thread pipeline recovers the same
overlap without processes:

    stage S (thread): seed + dispatch device DP   (score_reads)
    stage E (thread): fetch scores + emit encoded GAM records
    caller         : consume records (write/BGZF)

Queue depth is bounded so at most a few batches are in flight.

Copied from vg_tpu/parallel/pipeline.py.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator, List, Optional


def map_stream_encoded_mt(mapper, batches: Iterable, depth: int = 3
                          ) -> Iterator[List[bytes]]:
    """Yield encoded GAM record lists per batch, pipelined across threads."""
    q_scored: "queue.Queue" = queue.Queue(maxsize=depth)
    q_out: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()
    err: List[BaseException] = []

    score = getattr(mapper, "score_reads_packed", None) or \
        mapper.score_reads

    def seeder():
        try:
            for batch in batches:
                q_scored.put(score(batch))
        except BaseException as e:   # propagate to consumer
            err.append(e)
        finally:
            q_scored.put(DONE)

    def emitter():
        try:
            while True:
                sb = q_scored.get()
                if sb is DONE:
                    break
                recs = mapper.emit_batch_encoded(sb)
                if recs is None:
                    recs = [a.encode() for a in mapper.emit_batch(sb)]
                q_out.put(recs)
        except BaseException as e:
            err.append(e)
        finally:
            q_out.put(DONE)

    t1 = threading.Thread(target=seeder, daemon=True)
    t2 = threading.Thread(target=emitter, daemon=True)
    t1.start()
    t2.start()
    while True:
        recs = q_out.get()
        if recs is DONE:
            break
        yield recs
    t1.join()
    t2.join()
    if err:
        raise err[0]


def map_pairs_encoded_mt(paired_mapper, pair_batches: Iterable,
                         depth: int = 4, emitters: int = 2,
                         seeders: int = 1
                         ) -> Iterator[List[bytes]]:
    """Paired pipeline, three stages so the device roundtrip latency of
    batch i hides behind host work on batches i±1:

        S: seed + one folded DP dispatch           (score_pairs)
        R: force main scores, dispatch rescue DP   (stage_rescue)
        E: finish rescue, pair, emit encoded GAM   (stage_emit)

    S runs on `seeders` threads and E on `emitters` threads; batches
    are sequence-tagged at the source. The rescuer restores input order
    before dispatching rescue DP — stage_score on distinct batches only
    touches batch-local state plus read-only index arrays (the
    per-layout jit caches are built under the mapper's compile lock),
    while warmup-vs-steady behavior stays per batch whichever thread
    scores it. seeders defaults to 1: on the 4-vCPU bench host the
    native seeding kernel already fills every core via OpenMP, so a
    second seeder only adds contention (measured 49.3k -> 41.0k
    reads/s); raise it on hosts with more cores than one seed_batch
    call can use. stage_emit on distinct batches only shares read-only
    mapper state once the fragment model is finalized — warmup items
    (which mutate the fragment model) are serialized by the paired
    mapper's emit lock.

    Where the mapper has a stage clock (utils/stagetime), each thread's
    blocking queue calls are spans of it: wait.score_out (the seeder held
    back by a full queue downstream), wait.rescue_in, wait.rescue_out,
    wait.emit_in (the emitters idle for want of input) and wait.emit_out;
    and each stage call's spans carry its batch's sequence number."""
    span, set_batch = _clock_of(paired_mapper)
    q_scored: "queue.Queue" = queue.Queue(maxsize=depth)
    q_resc: "queue.Queue" = queue.Queue(maxsize=depth)
    q_out: "queue.Queue" = queue.Queue(maxsize=depth + emitters)
    DONE = object()
    LOST = object()   # a seeder failed on this seq: hole, not a batch
    err: List[BaseException] = []

    src = enumerate(pair_batches)
    src_lock = threading.Lock()

    def seeder():
        try:
            while True:
                if err:        # another stage failed: stop pulling input
                    break
                with src_lock:
                    # the input iterator itself may raise (e.g. a FASTQ
                    # reader hitting an IO error): that must still reach
                    # the finally below, or the rescuer waits forever
                    # for this seeder's DONE and the pipeline deadlocks
                    nxt = next(src, None)
                if nxt is None:
                    break
                seq, batch = nxt
                set_batch(seq)
                try:
                    item = paired_mapper.stage_score(batch)
                    with span("wait.score_out"):
                        q_scored.put((seq, item))
                except BaseException as e:
                    # mark the claimed seq as lost so the rescuer's
                    # in-order release can advance past the gap instead
                    # of buffering the rest of the stream unboundedly
                    err.append(e)
                    q_scored.put((seq, LOST))
                    break
                set_batch(None)
        except BaseException as e:
            err.append(e)
        finally:
            q_scored.put(DONE)

    def rescuer():
        pending = {}
        want = 0
        live = seeders
        try:
            while True:
                with span("wait.rescue_in"):
                    got = q_scored.get()
                if got is DONE:
                    live -= 1
                    if live == 0:
                        break
                    continue
                seq, item = got
                pending[seq] = item
                while want in pending:
                    item = pending.pop(want)
                    if item is not LOST:
                        set_batch(want)
                        item = paired_mapper.stage_rescue(item)
                        with span("wait.rescue_out"):
                            q_resc.put((want, item))
                        set_batch(None)
                    want += 1
            # a seeder died mid-stream: drain whatever arrived in order
            for seq in sorted(pending):
                if pending[seq] is not LOST:
                    q_resc.put(
                        (seq, paired_mapper.stage_rescue(pending[seq])))
        except BaseException as e:
            err.append(e)
        finally:
            for _ in range(emitters):
                q_resc.put(DONE)

    tail_lock = threading.Lock()
    tail_state = [emitters]          # emitters still running

    def emitter():
        try:
            while True:
                with span("wait.emit_in"):
                    got = q_resc.get()
                if got is DONE:
                    break
                seq, item = got
                set_batch(seq)
                recs = paired_mapper.stage_emit(item)
                with span("wait.emit_out"):
                    q_out.put((seq, recs))
                set_batch(None)
        except BaseException as e:
            err.append(e)
        finally:
            with tail_lock:
                tail_state[0] -= 1
                last = tail_state[0] == 0
            if last:
                try:
                    tail = paired_mapper.finish_encoded()
                    if tail:
                        q_out.put((1 << 62, tail))
                except BaseException as e:  # noqa: BLE001
                    err.append(e)
                q_out.put(DONE)

    threads = [threading.Thread(target=f, daemon=True)
               for f in ([seeder] * seeders + [rescuer]
                         + [emitter] * emitters)]
    for t in threads:
        t.start()
    pending = {}
    want = 0
    while True:
        got = q_out.get()
        if got is DONE:
            break
        seq, recs = got
        pending[seq] = recs
        while want in pending:
            yield pending.pop(want)
            want += 1
    for recs in (pending[k] for k in sorted(pending)):  # tail marker
        yield recs
    for t in threads:
        t.join()
    if err:
        raise err[0]


def _clock_of(mapper):
    """(span, set_batch) of the mapper's stage clock, or stand-ins that
    record nothing for a mapper without one."""
    clock = getattr(mapper, "stage_clock", None)
    if clock is None:
        return (lambda name: contextlib.nullcontext()), (lambda seq: None)
    return clock.span, clock.set_batch
