"""Multi-host initialization and the distributed-run entry point.

Capability parity: BASELINE.json:5,11 multi-host distributed BA. The
reference is single-process (SURVEY.md §2.1); this layer is new capability.

Process model: one Python process per host, launched with identical code;
``init_distributed`` wires them into one JAX runtime, after which
``jax.devices()`` spans all hosts and the single-host ``solve_sharded``
(tpu_ba/sharding/distributed.py) works unchanged — its mesh covers the
global device list and XLA's collectives carry the psums within and across
hosts.

Data model: every host builds (or loads) the same problem deterministically
(same file / same seed), then ``shard_problem`` gives each host's devices
their contiguous observation range — the keyframe partition. Only
`jax.Array` shards materialize locally.

Launch example (2 hosts):
    HOST0:  python -m tpu_ba.cli ba --sharded --coordinator host0:9876 \
                --num-processes 2 --process-id 0 ...
    HOST1:  python -m tpu_ba.cli ba --sharded --coordinator host0:9876 \
                --num-processes 2 --process-id 1 ...
"""

from __future__ import annotations

import os


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize ``jax.distributed`` from args or standard env vars
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID). Returns True when a
    multi-process runtime was initialized, False for single-process runs."""
    import jax

    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "-1") or -1)
    if not coordinator or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def scaling_report(wall_s_by_world_size: dict[int, float]) -> dict:
    """Scaling-efficiency table vs the smallest measured world size
    (BASELINE.json:5 "≥80% scaling efficiency at 2 hosts")."""
    base_n = min(wall_s_by_world_size)
    base_t = wall_s_by_world_size[base_n]
    out = {}
    for n, t in sorted(wall_s_by_world_size.items()):
        ideal = base_t * base_n / n
        out[n] = {"wall_s": t, "speedup": base_t / t,
                  "efficiency": ideal / t}
    return out
