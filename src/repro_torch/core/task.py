"""Task abstractions — the Radical-Pilot TaskDescription analogue.

A Task is an SPMD program (Python callable receiving a Communicator) plus its
resource requirements in *ranks* (devices).  The runtime constructs a private
communicator of exactly ``ranks`` devices at launch time and delivers it to
the payload — the equivalent of RAPTOR building a private MPI communicator
per task.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Callable, Optional

_uid = itertools.count()


class TaskState(enum.Enum):
    NEW = "NEW"
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELED = "CANCELED"


@dataclasses.dataclass
class TaskDescription:
    """What the user submits (mirrors rp.TaskDescription)."""
    name: str
    ranks: int                                   # devices required
    fn: Callable[..., Any]                       # fn(comm, *args) -> result
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    mesh_axes: tuple = ("df",)                   # axis names for the private mesh
    mesh_shape: Optional[tuple] = None           # default: (ranks,)
    priority: int = 0
    max_retries: int = 2
    duration_model: Optional[Callable[[int], float]] = None  # ranks -> seconds (sim)
    tags: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Task:
    desc: TaskDescription
    uid: int = dataclasses.field(default_factory=lambda: next(_uid))
    state: TaskState = TaskState.NEW
    result: Any = None
    error: Optional[str] = None
    retries: int = 0
    submit_time: float = 0.0
    start_time: float = 0.0
    end_time: float = 0.0
    comm_build_time: float = 0.0     # "overhead" column of paper Table 2
    devices: tuple = ()
    speculative_of: Optional[int] = None   # uid of the task this duplicates
    excluded_devices: set = dataclasses.field(default_factory=set)
    # devices prior attempts failed on; retries avoid them when possible
    placement: str = ""              # policy that placed this task's devices
    # (pack|spread; set by the scheduler at dispatch, recorded on the comm)
    p2p_bytes: int = 0               # bytes the task's collectives moved
    # worker-to-worker (peer data plane; 0 on sim/thread backends)
    hub_calls: int = 0               # parent-hub round-trips the task paid
    spills: int = 0                  # shuffle partitions spilled to disk
    # under the out-of-core path (0 on sim/thread backends)
    p2p_fallbacks: int = 0           # above-threshold payloads that relayed
    # through the hub because a peer channel could not be used
    hub_relay_bytes: int = 0         # real payload bytes the hub relayed for
    # this task's collectives (peer-plane collectives contribute only the
    # tiny PEER_SENT marker; 0 on sim/thread backends)
    raw_coll_bytes: int = 0          # collective bytes shipped with
    # zero-copy raw framing (0 on sim/thread backends)
    shm_bytes: int = 0               # payload bytes moved through same-host
    # shared-memory segments (a subset of p2p_bytes)
    ring_steps: int = 0              # ring-allgather block forwards paid
    ckpt_dir: str = ""               # task-lineage checkpoint dir under the
    # session ckpt root ("" = checkpointing off; set by the scheduler)
    ckpt_attempt: str = ""           # attempt namespace inside ckpt_dir
    # (a<retries> for primaries, s<uid> for speculative twins)
    resumed_from_step: int = 0       # last checkpoint step this attempt
    # restored before running (0 = ran from scratch)
    cache_hit: bool = False          # completed from the result cache
    # without dispatching (REPRO_RESULT_CACHE)
    cache_key: str = ""              # result-cache digest of (fn, args,
    # kwargs, ranks); "" when the payload is uncacheable
    spans: list = dataclasses.field(default_factory=list)   # the last
    # attempt's flight-recorder spans, the same dicts the session keeps:
    # [{kind, t0, t1, parent, attrs, worker, part, uid, task}, ...] on the
    # executor clock (empty on the virtual clock)

    @property
    def run_seconds(self) -> float:
        return self.end_time - self.start_time

    @property
    def wait_seconds(self) -> float:
        return self.start_time - self.submit_time
