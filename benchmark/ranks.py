"""A cell over k ranks: one process a card, each started by the harness.

For a workload whose ``chips`` is k > 1, the process that runs
``python3 -m benchmark.run …`` is rank 0. It starts ranks 1 … k−1
(:class:`Launch`) as ``sys.executable -m benchmark.run`` with its own
arguments and ``--rank r``, ``LOCAL_RANK`` and ``RANK`` = r and
``WORLD_SIZE`` = k in their environment, and relays their standard output
and error to its standard error, each line prefixed ``[rank r]``: only
rank 0 writes to standard output. The ranks meet on a ``file://`` store in
a fresh temporary directory, never a fixed port. ``program.join`` makes
the process group with the port's ``init_multihost`` (``nccl`` across the
cards, ``gloo`` on the CPU or for several ranks on one card), the mesh, and
a second, gloo-only group for host-side control (:class:`Ranks`).

Failure: rank 0 watches its ranks. One that exits before rank 0 has taken
the last of its results, or later with another code than 0, ends the run:
rank 0 kills the others, prints no result and exits with ``RANK_FAILED``,
within ``FAIL_BOUND_S`` of the exit. So does an error in rank 0 itself. A
rank whose rank 0 has gone ends itself (``PR_SET_PDEATHSIG``, and a look at
its parent's pid each second), so no process is left holding a card. No
barrier times out sooner than ``CONTROL_TIMEOUT``: a rank that died is
found by its exit, not by a clock, so a cold build may take its time.
"""

from __future__ import annotations

import collections
import ctypes
import datetime
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

# rank 0's decision at each call of the window, which every rank follows
GO, SLICE, STOP = 0, 1, 2
# calls between rank 0's decision and the call at which every rank follows
# it: the decisions travel without any rank's host waiting for another's
AGREE_LAG = 8
# the control group's timeout: longer than any cold set-up
CONTROL_TIMEOUT = datetime.timedelta(hours=4)
# a dead rank ends the run within this many seconds
FAIL_BOUND_S = 60
POLL_S = 0.2
RANK_FAILED = 4
# where the ranks run: one rank a card (nccl), all ranks on card 0 (gloo),
# or all on the CPU (gloo)
PLACES = ("cards", "one_card", "cpu")


class Ranks:
    """This process's place in a run of ``k`` ranks, and the gloo group
    that carries the host-side control: barriers, the window's decisions
    and the gathering of each rank's summary to rank 0. ``program.join``
    sets ``group``, ``mesh`` and ``device``."""

    def __init__(self, rank: int, k: int, place: str, store: str):
        self.rank, self.k, self.place, self.store = rank, k, place, store
        self.group = None
        self.mesh = None
        self.device = None
        self.launch: Optional["Launch"] = None   # rank 0's
        self.pending: collections.deque = collections.deque()

    @property
    def backend(self) -> str:
        """The process group's backend: NCCL refuses two ranks on one card,
        and runs on no CPU."""
        return "nccl" if self.place == "cards" else "gloo"

    @property
    def device_type(self) -> str:
        return "cpu" if self.place == "cpu" else "cuda"

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.group)

    def agree(self, decision: int) -> int:
        """Post rank 0's ``decision`` for this call, a one-element CPU
        tensor broadcast on the control group, started without waiting;
        return the decision rank 0 posted ``AGREE_LAG`` calls ago (``GO``
        while fewer are in flight), on every rank alike. It never waits on
        a stream, and a rank's host waits only for a decision made
        ``AGREE_LAG`` calls before."""
        import torch
        import torch.distributed as dist
        t = torch.tensor([decision], dtype=torch.int32)
        self.pending.append((t, dist.broadcast(t, src=0, group=self.group,
                                               async_op=True)))
        if len(self.pending) <= AGREE_LAG:
            return GO
        t, work = self.pending.popleft()
        work.wait()
        return int(t[0])

    def settle(self) -> None:
        """Wait for the decisions still in flight once the window's last
        call is made: every rank posted as many."""
        while self.pending:
            self.pending.popleft()[1].wait()

    def gather(self, obj) -> Optional[list]:
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        import torch.distributed as dist
        out = [None] * self.k if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def done(self) -> None:
        """Every rank's last result is on rank 0: from now on a rank may
        end (none does before rank 0 has said so, at the last barrier);
        every rank leaves the process group."""
        import torch.distributed as dist
        if self.launch is not None:
            self.launch.taken_all()
        self.barrier()
        if dist.is_initialized():
            dist.destroy_process_group()


def _relay(stream, rank: int, lock: threading.Lock) -> None:
    """Rank ``rank``'s output, line by line, on this process's standard
    error, each line prefixed ``[rank r]``."""
    for raw in iter(stream.readline, b""):
        line = raw.decode(errors="replace").rstrip("\n")
        with lock:
            sys.stderr.write(f"[rank {rank}] {line}\n")
            sys.stderr.flush()
    stream.close()


class Launch:
    """Ranks 1 … k−1 of this run, started by rank 0, and their watch."""

    def __init__(self, args: List[str], k: int, root: str):
        self.store = tempfile.mkdtemp(prefix="bench-ranks-")
        self.procs: List[subprocess.Popen] = []
        self.relays: List[threading.Thread] = []
        self.lock = threading.Lock()        # the watch's state
        self.out_lock = threading.Lock()    # standard error's lines
        self.taken = False   # rank 0 holds every rank's last result
        self.done = False
        self.failing = threading.Lock()   # one thread ends the run
        for r in range(1, k):
            env = dict(os.environ, LOCAL_RANK=str(r), RANK=str(r),
                       WORLD_SIZE=str(k))
            try:
                p = subprocess.Popen(
                    [sys.executable, "-m", "benchmark.run", *args,
                     "--rank", str(r), "--store", self.store,
                     "--parent", str(os.getpid())],
                    cwd=root, env=env, stdin=subprocess.DEVNULL,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            except OSError as e:
                self.fail(f"rank {r} could not start: {e}")
            self.procs.append(p)
            t = threading.Thread(target=_relay, daemon=True,
                                 args=(p.stdout, r, self.out_lock))
            t.start()
            self.relays.append(t)
        os.environ.update(LOCAL_RANK="0", RANK="0", WORLD_SIZE=str(k))
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while True:
            time.sleep(POLL_S)
            with self.lock:
                if self.done:
                    return
                for r, p in enumerate(self.procs, 1):
                    rc = p.poll()
                    if rc is not None and (rc != 0 or not self.taken):
                        self.fail(f"rank {r} exited with code {rc}")

    def taken_all(self) -> None:
        """Rank 0 holds every rank's last result: from now on a rank may
        end, with code 0."""
        with self.lock:
            self.taken = True

    def fail(self, why: str) -> None:
        """End the run: kill every rank, print why, exit with
        ``RANK_FAILED``. Never returns."""
        if not self.failing.acquire(blocking=False):
            while True:          # another thread is ending the run
                time.sleep(1.0)
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        for t in self.relays:
            t.join(timeout=5)
        shutil.rmtree(self.store, ignore_errors=True)
        with self.out_lock:
            print(f"benchmark: {why}; the run ends with no result",
                  file=sys.stderr, flush=True)
        os._exit(RANK_FAILED)

    def fail_after(self, error: BaseException) -> None:
        """End the run after an error in rank 0. Where a rank has exited
        (a collective in rank 0 fails as its peer goes), that exit is named
        as the cause. Never returns."""
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            gone = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                    if p.poll() is not None]
            if gone:
                self.fail(", ".join(f"rank {r} exited with code {rc}"
                                    for r, rc in gone))
            time.sleep(POLL_S / 2)
        self.fail(f"rank 0 failed: {type(error).__name__}: {error}")

    def finish(self) -> None:
        """Wait for every rank to end, at most ``FAIL_BOUND_S``, and for
        its output; a rank that ends with another code than 0, or does not
        end, fails the run."""
        deadline = time.monotonic() + FAIL_BOUND_S
        for r, p in enumerate(self.procs, 1):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                self.fail(f"rank {r} did not end within {FAIL_BOUND_S} s of "
                          "its last result")
        with self.lock:
            self.done = True
        for t in self.relays:
            t.join(timeout=5)
        bad = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
               if p.returncode != 0]
        if bad:
            self.fail(", ".join(f"rank {r} exited with code {rc}"
                                for r, rc in bad))
        shutil.rmtree(self.store, ignore_errors=True)


def guard(parent: int) -> None:
    """End this rank (a child of rank 0, pid ``parent``) as soon as rank 0
    has gone: the kernel's ``PR_SET_PDEATHSIG`` where it has one, and a
    look at the parent's pid each second."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(RANK_FAILED)

    def watch() -> None:
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(RANK_FAILED)

    threading.Thread(target=watch, daemon=True).start()
