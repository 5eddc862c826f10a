"""Request-batching executor: concurrent generate requests served in batches.

PyTorch counterpart of `invertible_cd_tpu/serving.py`:

  * concurrent `submit()` calls enqueue (prompt, seed) requests;
  * one worker thread coalesces up to the largest of `batch_sizes`
    requests (waiting at most `max_delay` after the first), pads the batch
    with repeats of its last request up to the smallest size in
    `batch_sizes` that fits, and runs one `pipe.generate` call;
  * each request gets its own latent, drawn from its own seed, so padding
    never changes a request's output: row i of a batch is a function of
    (prompt_i, latent_i) and of the batch's size.

The port runs eagerly, so there are no compiled programs to count and
`stats()` has no `jit_programs` entry; a batch size is still a set of
kernel shapes, and one size always takes the same algorithms as long as
`torch.backends.cudnn.benchmark` stays off (its default, which nothing in
the package changes). A completion thread copies each batch's images to
the host and resolves its futures while the worker dispatches the next
batch.

Serving over a mesh (`mesh=`, `parallel.make_mesh(dp=..., sp=...)`, one
process per card): rank 0 runs the executor, and for each batch broadcasts
its prompts and seeds to every rank. Each dp group generates its contiguous
`batch / dp` rows from their own seeds; within the group each sp rank holds
its rows of every latent's height (`generate(mesh=...)`, JAX's
`latent_sharding`), and rank 0 gathers the images through the host. The
other ranks run `serve_follower`, which the executor's shutdown ends. Every
batch size must divide over dp (sp splits height, not the batch).

Usage:
    pipe = InvertibleCD.sd15()
    with BatchingExecutor(pipe, batch_sizes=(1, 4)) as ex:
        image = ex.submit("a corgi", seed=7).result()  # (H, W, 3) float32 [0, 1]

`cli/serve.py` wraps this in an HTTP endpoint.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional, Sequence

import numpy as np
import torch

from .parallel import broadcast_object, gather_objects, process_local_batch_slice

UINT64 = 2**64 - 1
# at most this many batches wait for the completion thread; the worker
# blocks on the next one (backpressure on device memory)
MAX_WAITING_BATCHES = 2


def latent_seed(seed: int) -> int:
    """The generator seed of a request's latent: the int64 seed as uint64,
    through splitmix64's finaliser (a bijection of 64-bit integers). A CUDA
    generator (Philox) keys on all 64 bits of its seed, but the CPU one
    (mt19937) on the low 32 only, so without the mix two seeds that differ
    only above bit 31 would draw the same latent on the CPU."""
    z = seed & UINT64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & UINT64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & UINT64
    return z ^ (z >> 31)


def _resolve(fut: Future, value=None, error: Exception | None = None) -> None:
    """set_result/set_exception tolerant of a client cancel() racing the
    done() check: a just-cancelled future raises InvalidStateError on set,
    which must not fail the rest of the batch's futures."""
    try:
        if fut.done():
            return
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass


def _fail(batch, error: Exception) -> None:
    for _, _, fut, _ in batch:
        _resolve(fut, error=error)


def request_latents(pipe, seeds: Sequence[int]) -> torch.Tensor:
    """(N, h, w, 4) float32 latents on the pipeline's device, row i drawn
    by a generator on that device seeded with `latent_seed(seeds[i])`."""
    h, w = pipe.latent_size
    device = pipe.device
    return torch.stack([
        torch.randn((h, w, 4), device=device,
                    generator=torch.Generator(device=device).manual_seed(latent_seed(s)))
        for s in seeds])


def _mesh_rows(pipe, prompts, seeds, guidance, model, mesh):
    """This rank's dp rows of a batch, generated (their height split over
    the sp group) and gathered through the host: the whole batch's images
    (a CPU tensor) on rank 0, None on the others. The first rank of each sp
    group sends its dp rows' images, the others only an error they met; a
    rank whose rows failed sends its error, and rank 0 raises it after the
    gather (so no rank waits forever)."""
    lo, n = process_local_batch_slice(len(prompts), mesh)
    first_of_sp = mesh.coordinate("sp") == 0
    try:
        images, _ = pipe.generate(prompts[lo:lo + n], latent=request_latents(pipe, seeds[lo:lo + n]),
                                  guidance=guidance, model=model, mesh=mesh)
        mine = images.cpu().numpy() if first_of_sp else None
    except Exception as e:  # noqa: BLE001 — rank 0 raises it
        mine = e
    parts = gather_objects(mine, mesh)
    if parts is None:
        return None
    for part in parts:
        if isinstance(part, Exception):
            raise part
    return torch.from_numpy(np.concatenate([p for p in parts if p is not None]))


def serve_follower(pipe, mesh, guidance=None, model: str = "reverse") -> int:
    """The loop of a mesh rank other than 0: generate this rank's rows of
    each batch rank 0's executor broadcasts, until its shutdown. Returns the
    number of batches served."""
    guidance = guidance or pipe.default_guidance()
    served = 0
    while True:
        msg = broadcast_object(None, mesh)
        if msg is None:
            return served
        _mesh_rows(pipe, *msg, guidance, model, mesh)
        served += 1


class BatchingExecutor:
    """Coalesce concurrent generation requests into batches.

    Args:
      pipe: an InvertibleCD / InvertibleCDXL bundle.
      batch_size: the largest batch, when `batch_sizes` is not given.
      batch_sizes: the batch sizes to run, e.g. (1, 4, 8): the worker
        dispatches each coalesced batch at the smallest size that fits it,
        so a lone request runs at batch 1 instead of filling padded slots.
        Defaults to (batch_size,).
      max_delay: seconds the worker waits for more requests after the
        first of a batch arrives (latency/throughput knob).
      guidance: GuidanceConfig shared by every request
        (`pipe.default_guidance()` when None).
      model: student to sample from ("reverse" by default).
      mesh: a `parallel.Mesh` to serve over its dp x sp ranks (this
        process is rank 0; the others run `serve_follower`). Every batch
        size must divide over dp.
    """

    def __init__(
        self,
        pipe,
        batch_size: int = 8,
        max_delay: float = 0.01,
        guidance=None,
        model: str = "reverse",
        mesh=None,
        batch_sizes: Optional[Sequence[int]] = None,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.pipe = pipe
        self.batch_sizes = tuple(sorted(set(batch_sizes or (batch_size,))))
        if any(b < 1 for b in self.batch_sizes):
            raise ValueError("batch_sizes must all be >= 1")
        self.batch_size = self.batch_sizes[-1]
        self.max_delay = max_delay
        self.guidance = guidance or pipe.default_guidance()
        self.model = model
        self.mesh = mesh
        if mesh is not None:
            if mesh.fsdp > 1 or mesh.tp > 1 or mesh.rank != 0:
                raise ValueError("the executor runs on rank 0 of a dp x sp mesh (fsdp 1, tp 1); "
                                 "the other ranks run serve_follower")
            dp = mesh.dp
            bad = [b for b in self.batch_sizes if dp > 1 and b % dp != 0]
            if bad:
                raise ValueError(
                    f"batch sizes {bad} must divide over the mesh's "
                    f"dp={dp} batch shards"
                )
        self._queue: queue.Queue = queue.Queue()
        # Completion pipeline: the worker hands each batch's images, still
        # on the device, to the completion thread and goes on to the next
        # batch. The queue itself is unbounded, so the worker's final
        # sentinel never blocks (a completion thread wedged in a copy must
        # not hang shutdown); `_slots` bounds the batches waiting in it.
        self._completion: queue.Queue = queue.Queue()
        self._slots = threading.BoundedSemaphore(MAX_WAITING_BATCHES)
        self._handover_lock = threading.Lock()
        self._abandoned = False  # shutdown stopped waiting for the completion thread
        device = pipe.device
        self._copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._stats = {"requests": 0, "batches": 0, "padded_slots": 0, "expired": 0}
        self._stats_lock = threading.Lock()
        self._shutdown = threading.Event()
        # serializes submit()'s check-then-put against shutdown()'s
        # set-then-drain (without it a submit could pass the check, lose
        # the CPU, and enqueue after the drain: its future would hang)
        self._submit_lock = threading.Lock()
        self._completer = threading.Thread(
            target=self._complete, name="icd-serving-completer", daemon=True)
        self._completer.start()
        self._worker = threading.Thread(target=self._run, name="icd-serving-worker", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, prompt: str, seed: Optional[int] = None,
               timeout: Optional[float] = None) -> Future:
        """Enqueue one request; the Future resolves to an (H, W, 3) float32
        [0, 1] numpy image.

        `timeout` (seconds) bounds the time a request may wait for dispatch:
        if the worker picks it up after the deadline, its future fails with
        TimeoutError instead of occupying a batch slot. A request that makes
        it into a batch before the deadline completes normally.

        Raises ValueError for a seed outside int64 here rather than in the
        worker: one bad request must not poison the whole batch."""
        if seed is not None and not (-(2**63) <= seed < 2**63):
            raise ValueError("seed must fit in int64")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._submit_lock:
            if self._shutdown.is_set():
                raise RuntimeError("executor is shut down")
            fut: Future = Future()
            self._queue.put((prompt, seed, fut, deadline))
        with self._stats_lock:
            self._stats["requests"] += 1
        return fut

    def generate(self, prompt: str, seed: Optional[int] = None) -> np.ndarray:
        """Synchronous convenience wrapper around submit()."""
        return self.submit(prompt, seed).result()

    def stats(self) -> dict:
        """Requests, batches, padded slots, expired requests, and batches
        by size (`batches_b{size}`)."""
        with self._stats_lock:
            return dict(self._stats)

    def shutdown(self, wait: bool = True, timeout: float = 600.0):
        """Refuse new requests, serve the ones already collected and stop
        both threads. With `wait`, block up to `timeout` seconds in all for
        the threads; a completion thread still busy then (wedged in a copy)
        is left behind, and the batches waiting for it fail. Requests still
        queued when the worker stops fail with RuntimeError."""
        with self._submit_lock:
            # under the lock: no submit can be mid check-then-put, so
            # after this point every submit() raises instead of enqueuing
            self._shutdown.set()
            self._queue.put(None)  # unblock the worker's queue.get
        if wait:
            deadline = time.monotonic() + timeout
            self._worker.join(timeout)
            # the worker's final sentinel stops the completer after the
            # last batch handed to it resolves
            self._completer.join(max(0.0, deadline - time.monotonic()))
            if self._completer.is_alive():
                with self._handover_lock:
                    self._abandoned = True
                    while True:
                        try:
                            item = self._completion.get_nowait()
                        except queue.Empty:
                            break
                        if item is not None:
                            _fail(item[0], RuntimeError("executor is shut down"))
                    self._completion.put(None)  # stops the completer if it ever returns
        # Fail whatever is still queued (enqueued before the sentinel but
        # never collected). If the worker is still alive (join timed out
        # mid-batch, or wait=False), the drain may have consumed its
        # sentinel: put one back so the worker exits instead of blocking
        # forever in queue.get().
        drained_sentinel = False
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                drained_sentinel = True
            else:
                _resolve(item[2], error=RuntimeError("executor is shut down"))
        if drained_sentinel and self._worker.is_alive():
            self._queue.put(None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # ------------------------------------------------------------------
    def _collect(self):
        """Block for the first request, then soak up to batch_size until a
        deadline of max_delay after the first arrival (a per-get timeout
        would restart the clock on every straggler). Returns a list of
        (prompt, seed, future, deadline), or None on shutdown."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_delay
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # propagate shutdown after serving what we have
                break
            batch.append(item)
        return batch

    def _latents(self, seeds: Sequence[int]) -> torch.Tensor:
        """`request_latents` of this executor's pipeline."""
        return request_latents(self.pipe, seeds)

    def _generate(self, prompts, seeds) -> torch.Tensor:
        """One batch's images: one `pipe.generate` call, or over the mesh
        (the followers get the batch first)."""
        if self.mesh is None:
            return self.pipe.generate(prompts, latent=self._latents(seeds),
                                      guidance=self.guidance, model=self.model)[0]
        broadcast_object((prompts, seeds), self.mesh)
        return _mesh_rows(self.pipe, prompts, seeds, self.guidance, self.model, self.mesh)

    def _hand_over(self, item) -> bool:
        """Queue a batch for the completion thread, blocking while
        MAX_WAITING_BATCHES wait for it; False if shutdown gave up on it."""
        while not self._slots.acquire(timeout=0.1):
            if self._abandoned:
                return False
        with self._handover_lock:
            if self._abandoned:
                return False
            self._completion.put(item)
        return True

    def _complete(self):
        """Copy each batch's images to the host and resolve its futures; an
        error in the batch's device work surfaces here, at the copy."""
        while True:
            item = self._completion.get()
            if item is None:
                return
            self._slots.release()
            batch, images, done, n = item
            try:
                if done is None:
                    host = images[:n].numpy()
                else:
                    # The copy waits for this batch's kernels only (the event
                    # the worker recorded after them), on a stream of its own:
                    # on the default stream it would queue behind the next
                    # batch's kernels, which the worker is already launching.
                    # So the device-to-host copy and the resolving of the
                    # futures overlap the next batch's device work.
                    with torch.cuda.stream(self._copy_stream):
                        self._copy_stream.wait_event(done)
                        host = images[:n].cpu().numpy()
                for (_, _, fut, _), img in zip(batch, host):
                    _resolve(fut, img)  # the client may have cancel()ed
            except Exception as e:  # noqa: BLE001 — the futures carry the error
                _fail(batch, e)

    def _run(self):
        rng = np.random.default_rng(0)
        try:
            self._run_loop(rng)
        finally:
            if self.mesh is not None:
                broadcast_object(None, self.mesh)  # ends the followers' loops
            self._completion.put(None)  # unbounded: never blocks

    def _run_loop(self, rng):
        while True:
            batch = self._collect()
            if batch is None:
                break
            # expire requests whose dispatch deadline passed while queued
            # (and skip client-cancelled futures) before they cost a slot
            now = time.monotonic()
            live = []
            for item in batch:
                _, _, fut, deadline = item
                if fut.cancelled():
                    continue
                if deadline is not None and now > deadline:
                    _resolve(fut, error=TimeoutError("request expired before dispatch"))
                    with self._stats_lock:
                        self._stats["expired"] += 1
                    continue
                live.append(item)
            if not live:
                continue
            batch = live
            prompts = [p for p, _, _, _ in batch]
            seeds = [s if s is not None else int(rng.integers(0, 2**31 - 1))
                     for _, s, _, _ in batch]
            n = len(batch)
            # the smallest size that fits: few requests run few padded rows
            size = next(b for b in self.batch_sizes if b >= n)
            pad = size - n
            if pad:
                prompts = prompts + [prompts[-1]] * pad
                seeds = seeds + [seeds[-1]] * pad
            try:
                images = self._generate(prompts, seeds)
                done = None
                if images.is_cuda:
                    done = torch.cuda.Event()
                    done.record()
            except Exception as e:  # noqa: BLE001 — the futures carry the error
                _fail(batch, e)
            else:
                if not self._hand_over((batch, images, done, n)):
                    _fail(batch, RuntimeError("executor is shut down"))
            with self._stats_lock:
                self._stats["batches"] += 1
                self._stats["padded_slots"] += pad
                self._stats[f"batches_b{size}"] = self._stats.get(f"batches_b{size}", 0) + 1
