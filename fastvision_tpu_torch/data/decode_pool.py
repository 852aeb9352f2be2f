"""Process-parallel host work into a shared-memory ring buffer (port of
fastvision_tpu/data/decode_pool.py).

  - N worker processes run the caller's work function (decode, resize,
    augment); no GIL, so the work scales with cores;
  - each worker writes its fixed-shape uint8 output into a preallocated
    SharedMemory slot; only the small aux payload rides the result queue;
  - the parent reassembles results IN ORDER and recycles slots, so memory
    stays bounded at ``n_slots`` whatever the workers' skew;
  - determinism is the caller's contract: per-item random draws seeded by
    (seed, epoch, position), as the serial and thread paths draw them, so
    every backend gives the same batches.

Workers run torch's CPU ops (the loaders resize with
``torch.nn.functional.interpolate``). A child forked from a parent whose
intra-op thread pool already ran can hang in its first parallel region, so
each worker sets ``torch.set_num_threads(1)`` before any work, as
``torch.utils.data`` workers do. Workers never touch CUDA: forking a parent
that holds a CUDA context is safe while the child stays on the host.

The start method is ``fork`` unless the caller names ``forkserver`` or
``spawn``; those pickle the work function, and a script that drives them
must guard its entry point with ``if __name__ == "__main__":``. Such a
worker starts from a fresh import, so it is handed the parent's native
build directory (`cuda_build.build_dir`: ``compile_cache``) and loads the
libraries the parent built there.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as _queue
import weakref
from collections import deque
from multiprocessing import shared_memory
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from .. import cuda_build
from .codec import jpeg_library

_SENTINEL = None


def _worker(work_fn, task_q, result_q, shm_name, slot_shape, build_dir):
    torch.set_num_threads(1)
    cuda_build.set_build_dir(build_dir)  # a no-op in a forked worker
    shm = shared_memory.SharedMemory(name=shm_name)
    slot_bytes = int(np.prod(slot_shape))
    try:
        while True:
            task = task_q.get()
            if task is _SENTINEL:
                break
            pos, slot, item = task
            try:
                out, aux = work_fn(item)
                if out.dtype != np.uint8:  # the JAX package's pool casts unchecked
                    raise ValueError(
                        f"the process pool's slots hold uint8; a sample came out {out.dtype} "
                        "(an augmentation ending in 'normalization' needs "
                        "worker_backend='thread' or num_workers <= 1)")
                view = np.ndarray(
                    slot_shape, np.uint8,
                    buffer=shm.buf[slot * slot_bytes : (slot + 1) * slot_bytes])
                # an output smaller than the slot is written into its corner
                view[tuple(slice(0, s) for s in out.shape)] = out
                result_q.put((pos, slot, out.shape, aux, None))
            except BaseException as e:  # surface the real error in the parent
                result_q.put((pos, slot, None, None, repr(e)))
    finally:
        shm.close()


class DecodePool:
    """Ordered process-parallel map over items, outputs in shared memory.

    ``work_fn(item) -> (uint8 array with shape <= slot_shape, aux)`` runs in
    the workers; ``imap(items)`` yields (view, aux) in submission order. The
    yielded view aliases a ring slot and is valid ONLY until the next
    iteration (copy it into the batch buffer before advancing).

    ``num_workers=0`` is a serial in-process map with the same contract.
    """

    def __init__(self, work_fn: Callable, num_workers: int, slot_shape: tuple[int, ...],
                 n_slots: int | None = None, start_method: str = "fork"):
        self.work_fn = work_fn
        self.num_workers = int(num_workers)
        self.slot_shape = tuple(int(s) for s in slot_shape)
        if self.num_workers <= 0:
            return
        self.n_slots = n_slots or max(4 * self.num_workers, 8)
        # the JPEG decoder's library is built and loaded here, once, not in
        # each worker (a forked worker inherits it)
        jpeg_library()
        self._slot_bytes = int(np.prod(self.slot_shape))
        ctx = mp.get_context(start_method)
        self._shm = shared_memory.SharedMemory(create=True,
                                               size=self._slot_bytes * self.n_slots)
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker, daemon=True,
                        args=(work_fn, self._task_q, self._result_q, self._shm.name,
                              self.slot_shape, cuda_build.build_dir()))
            for _ in range(self.num_workers)]
        for p in self._procs:
            p.start()
        self._outstanding = 0  # tasks submitted but not yet collected
        # workers stop when the pool is closed, collected, or at exit
        self._finalizer = weakref.finalize(self, _shutdown, self._procs, self._task_q,
                                           self._shm)

    def _get_result(self):
        """The next result off the queue; raises if a worker died (e.g.
        OOM-killed) instead of waiting forever."""
        while True:
            try:
                out = self._result_q.get(timeout=30)
            except _queue.Empty:
                dead = [p.pid for p in self._procs if not p.is_alive()]
                if dead:
                    raise RuntimeError(f"DecodePool worker process(es) died: {dead}") from None
                continue
            self._outstanding -= 1
            return out

    def imap(self, items: Iterable) -> Iterator[tuple[np.ndarray, object]]:
        if self.num_workers <= 0:
            for item in items:
                yield self.work_fn(item)
            return
        # an imap abandoned mid-flight leaves results (and workers still
        # writing slots) in the pipe: drain them before reusing the ring,
        # or stale writes would land in fresh slots
        while self._outstanding > 0:
            self._get_result()

        items = iter(items)
        free = deque(range(self.n_slots))
        pending: dict[int, tuple] = {}
        submitted = next_pos = 0
        done_submitting = False

        def submit_while_possible():
            nonlocal submitted, done_submitting
            while free and not done_submitting:
                try:
                    item = next(items)
                except StopIteration:
                    done_submitting = True
                    return
                self._task_q.put((submitted, free.popleft(), item))
                submitted += 1
                self._outstanding += 1

        submit_while_possible()
        while next_pos < submitted or not done_submitting:
            while next_pos not in pending:
                pos, slot, shape, aux, err = self._get_result()
                if err is not None:
                    raise RuntimeError(f"DecodePool worker failed: {err}")
                pending[pos] = (slot, shape, aux)
            slot, shape, aux = pending.pop(next_pos)
            start = slot * self._slot_bytes
            view = np.ndarray(shape, np.uint8,
                              buffer=self._shm.buf[start : start + int(np.prod(shape))])
            next_pos += 1
            yield view, aux
            del view  # drop the buffer reference before the slot recycles
            free.append(slot)
            submit_while_possible()

    def close(self) -> None:
        if self.num_workers > 0:
            self._finalizer()


def _shutdown(procs, task_q, shm) -> None:
    for _ in procs:
        try:
            task_q.put(_SENTINEL)
        except (ValueError, OSError):
            pass
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()  # this child's PID, never matched by pattern
            p.join(timeout=5)
    try:
        shm.close()
        shm.unlink()
    except FileNotFoundError:
        pass
