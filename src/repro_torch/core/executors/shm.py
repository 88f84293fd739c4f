"""Same-host shared-memory payload handoff — the fastest transport tier.

When two workers of a spanning task advertise the SAME host in the peer
address book, a collective payload's body does not need the socket at all:
the sender writes it into a tmpfs-backed segment file under ``/dev/shm``
and ships only the segment name + layout header as a PEER_DATA_SHM frame;
the receiver reads it back and unlinks.  One kernel copy per side, no TCP
stack, no per-chunk socket syscalls — the same reason the Cylon line of
work leans on buffer-level local transports before hitting the wire.

Why plain files instead of ``multiprocessing.shared_memory``: a fresh
``shm_open`` + ``mmap`` per payload pays a minor page fault for every 4 KiB
touched on BOTH sides, which measures ~3.5x SLOWER than loopback TCP at
1 MiB; ``write()``/``read()`` on the same tmpfs keeps the copies in the
kernel (no faulting, no mmap churn, no resource_tracker to fight) and beats
the socket.  Same mount, same lifetime semantics, simpler cleanup.

Cleanup is a protocol, not a hope — a segment file outlives its creator,
so every path must account for it:

* **consume** — the receiver unlinks right after reading (normal case);
* **purge** — a parked-but-unclaimed frame (attempt ended first) is
  unlinked by the mailbox purge; an ABORTED sender unlinks every segment
  it created for the attempt (``_PeerNet`` keeps the per-attempt ledger);
* **sweep** — the parent removes ``/dev/shm`` residue by name prefix after
  a worker is SIGKILLed/retired and at shutdown.  Segment names embed the
  pilot token and the CREATOR's worker id (``repro_{tok8}_{wid}_{pid}_{n}``)
  precisely so the parent can target a dead worker's leftovers — the one
  cleanup no worker can perform for itself after SIGKILL.
"""
from __future__ import annotations

import itertools
import os
from pathlib import Path

SHM_DIR = Path("/dev/shm")
HAVE_SHM = os.name == "posix" and SHM_DIR.is_dir()

_counter = itertools.count()


def segment_name(token: str, worker_id: str) -> str:
    """A host-unique segment name carrying the sweep handles: pilot token
    prefix (shutdown sweep) and creator worker id (death/retire sweep)."""
    return (f"repro_{(token or 'anon')[:8]}_{worker_id}_"
            f"{os.getpid()}_{next(_counter)}")


def write(name: str, bufs) -> int:
    """Write the payload body (an iterable of buffers) into segment
    ``name``; returns the byte count.  Raises OSError when /dev/shm is
    full or unusable — the caller drops to the next tier."""
    total = 0
    with open(SHM_DIR / name, "wb") as f:
        for b in bufs:
            total += f.write(b)
    return total


def read(name: str) -> bytes:
    """The segment's body (raises FileNotFoundError when it was already
    reclaimed — e.g. the attempt aborted and the sender purged)."""
    with open(SHM_DIR / name, "rb") as f:
        return f.read()


def unlink(name: str) -> bool:
    """Best-effort removal of a segment by name; True when it existed."""
    try:
        os.unlink(SHM_DIR / name)
        return True
    except (FileNotFoundError, OSError):
        return False


def sweep(prefix: str) -> int:
    """Unlink every ``/dev/shm`` entry starting with ``prefix`` — the
    parent-side safety net for segments whose creator died before the
    header (and thus the cleanup obligation) reached any receiver.  Returns
    the number removed; a no-op on hosts without a /dev/shm mount."""
    if not HAVE_SHM:
        return 0
    n = 0
    for p in SHM_DIR.glob(prefix + "*"):
        try:
            p.unlink()
            n += 1
        except OSError:
            pass
    return n
